#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one H100 SXM

Phases, all run every time:
  build           csrc/gram.cu and csrc/instance_norm.cu, one nvcc each,
                  started together (sm_90a).
  kernels         hold gram_fwd, gram_bwd, pooled_gram_fwd and
                  pooled_gram_bwd against their
                  plain PyTorch versions at the main path's shapes in f32
                  and bf16, on non-negative inputs as the main path's
                  post-ReLU features are (gram_fwd and gram_bwd also at
                  the content+style loop's layer2 and layer3 Grams,
                  (4,28,28,512) and (4,14,14,1024); gram_fwd also at two ragged
                  shapes and at family 3's (32|1,4,4,64), gram_bwd at
                  three, each row naming its route and
                  splits, gram_bwd's also its two-call yardstick;
                  pooled_gram_fwd also at three ragged shapes, three
                  with S > 16 and the family-2 camera's (1,56,56,256) S 7,
                  each row naming S, its route and splits);
                  instance_norm_fwd likewise at the fast-style net's
                  shapes (B = 8, with and without ReLU, per-image affine
                  rows that differ), at C = 48, C = 5,
                  (1,512,512,32) bf16, (1|4,224,224,32), on channels of
                  mean 1e3, and at family 3's shapes under norm "instance"
                  (unit scale, zero bias, ReLU; B = 32 up to C = 1024, and
                  (1,13,13,1024)), on signed inputs as conv outputs are, each row
                  naming its route (cluster or split), cluster size,
                  resident share, bytes read twice and the clusters the card
                  holds at once, cluster rows also timing the split route;
                  the cluster route forced onto ragged shapes and a
                  misaligned bf16 input; instance_norm_bwd (dx, dscale,
                  dbias) at the family-3 style loop's b1 shapes and
                  (32,112,112,64) (ReLU, unit affine) and at the net's b8
                  shapes (affine rows, with and without ReLU), f32 and
                  bf16, each row naming its route (cluster or split), k,
                  G, clusters at once and bytes read twice, the b1 rows
                  also on the split route, forced, and every row's two
                  calls bit-equal; its cluster route forced onto ragged
                  plans and a misaligned input refused; gram_bwd also at
                  the loop's (1,4,4,64); at the fast-style training step's
                  b16 shapes: gram_fwd and gram_bwd at the four stage
                  outputs (16,56,56,256) to (16,7,7,2048), each gram_bwd
                  row also saying whether two calls gave the same bits,
                  and instance_norm_fwd and instance_norm_bwd at the net's
                  (16,224,224,32), (16,112,112,64) and (16,56,56,128),
                  with and without ReLU, affine rows that differ;
                  pooled_gram_bwd (family-2 training) from the forward
                  kernel's Y at the b32 stage outputs (32,56,56,256),
                  (32,28,28,512) and (32,14,14,1024) at S 7, at
                  overlapping bins (C = 10), C < S, S = 24, S = 64 and
                  odd C, each row naming its store mode (bulk or
                  scalar), saying whether two calls gave the same bits,
                  giving the new bound (Y, dG, dF) and that of a backward
                  that reads F (F, dG, dF) and timing autograd through
                  the two-einsum composition,
                  less its forward, as the library; pooled_gram_fwd's Y
                  on the bulk, scalar and project routes against the
                  plain Y, the forward timed with and without it; the
                  forward-only wrappers (gram_fwd,
                  pooled_gram_fwd, instance_norm_fwd) refuse inputs that
                  need a gradient;
                  time the kernel, the plain version and a library call;
                  compute each bound from the shapes and the card's peak
                  rates.
  classification  family 2 at full width (truncate 8, S 7, 4 classes, 224²
                  crops, batch 8, 16 images, seeded random weights) through
                  the npz writer, the npz reader, the weight bridge and the
                  function the CLI's ``--mode classification`` calls.
  style_transfer  the Adam-on-pixels loop through the function the CLI's
                  ``--mode style_transfer`` calls (layers 5, batch 4,
                  20 iterations, threshold 0).
  fast_style      ``serve_style --net`` through the CLI's ``start``: the
                  classic net (width 32, 5 residual blocks, crop 224, seeded
                  weights) written as style_net.npz and its hyperparameters,
                  batch sizes 4,8, 16 raw 224² POSTs from 8 threads; one
                  answer against the same net on the CPU.
  conditional     a 3-style conditional net through make_net_job_fn with
                  blended rows that differ per image, against the CPU; the
                  same net in bf16 through make_stylize_fn against f32.
  texture_serve   ``serve_style`` texture mode on the classification
                  phase's model (layers 5, 5 iterations, batch 2, 2 POSTs).
  family1_classification
                  family 1 at full width (truncate 8, dim 256, 4 classes,
                  seeded weights through the npz writer and the CLI's
                  loader): ``--mode classification``'s device loop and text
                  artifacts over 4 b32 batches of staged 256² uint8,
                  threshold 0, f32 and bf16; images/s from the per-batch
                  spans; batch 0 against the same model on the CPU.
  family1_inference
                  ``run_inference`` over 40 PNGs written here, with timing;
                  the JSON's schema and its probabilities against the CPU.
  camera          the camera infer functions at b1, f32 and bf16, 100
                  frames each after one warm-up: host-downscaled 224² RGB,
                  480x640 RGB resized on the card, planar I420 and the
                  stateful I420 delta (whose probabilities must equal the
                  I420 path's on the same frames); frames/s and p50 per
                  path, frame 1 against the CPU.
  camera_video    ``--mode camera`` through the CLI on a 30-frame 640x480
                  MJPG file written here (OpenCV is on the card machine),
                  then ``run_camera`` on the card and on the CPU.
  family3_classification
                  family 3 at full width (the config defaults: patch sizes
                  10/70/150, ndf 64, gram dim 64, 4 classes; seeded weights
                  through the npz writer and the CLI's loader):
                  ``--mode classification``'s device loop and JSON writer
                  over 4 b32 batches of staged 256² uint8, f32 and bf16;
                  images/s from the per-batch spans; batch 0's logits,
                  embeddings and Gram norms against the same model on the
                  CPU; gram_fwd launched 16 times a forward. Then the same
                  at norm "instance" over 2 batches, instance_norm_fwd
                  launched 13 times a forward.
  embeddings      ``compute_embeddings_with_paths`` for families 1 (b32), 2
                  (b8) and 3 (b32) at full width, 2 batches each, against
                  the CPU; family 1 writes its ``<model>_embeddings.json``.
  family3_camera, family2_camera
                  the host-downscaled RGB camera path at b1, f32, 50
                  frames each: p50 and frames/s, frame 1 against the CPU.
  family3_style_transfer
                  ``style_transfer_patches`` (the CLI's ``--mode
                  style_transfer``, b1) at full width, f32 and bf16 at norm
                  "batch" and f32 at norm "instance": 2 images of 20
                  iterations, threshold 0, every launch counted (16
                  gram_fwd and 16 gram_bwd an iteration, and 13
                  instance_norm_fwd and 13 instance_norm_bwd under
                  "instance", plus each image's target forward); image 0
                  against the CPU from the same noise: the first-step
                  pixel gradient, and a 10-iteration loop towards its Gram
                  plus a seeded offset that makes Adam move the pixels
                  (every loss, and the pixels' change by RMS, within twice
                  the CPU loop's own spread from noise nudged by 1e-7;
                  bf16 against the CPU's f32 loop); image-iterations/s and
                  the device idle share.
  pth             each family's seeded full-width model (family 3 the test
                  variant) through the port's exporter to a reference-layout
                  .pth, read back by the CLI's loader: logits on the card
                  equal to the .npz model's bit for bit; convert_checkpoint
                  npz -> pth -> npz gives back the same tree.
  gradcam         family 1's ``--mode classification`` through its CLI with
                  ``--save_test_images --visualize_gradcam
                  --save_gradcam_images --tensorboard`` on 8 PNGs written
                  here (b4): every overlay at 224x672x3, the card's CAMs
                  against the CPU's (1e-3 max abs), ms per CAM, and
                  whether TensorBoard wrote its log.
  content_style   family 2's content+style loop through
                  ``content_style_transfer_gram_attention`` at truncate 8,
                  --layers 8 --style_layers all (a Gram at each of the
                  four stages), b4, 224², init "content", 20 iterations,
                  f32 and bf16: exact launch counts (4 gram_fwd and 4
                  gram_bwd an iteration), the f32 loss falls, the pixels'
                  change over 2 iterations against the CPU's within the
                  CPU's own spread, image-iterations/s and busy and idle
                  per iteration; then the family-2 CLI's --style_image
                  once (4 images, 2 iterations).
  content_style_serve
                  ``serve_style --style_image a=... --style_image b=...``
                  (--style_layers all, 5 iterations, batch 4): GET
                  /styles, 8 concurrent POSTs (one-hot a, one-hot b and
                  a:0.5,b:0.5), each one-hot answer against the service's
                  job program run in process (99.9% within one uint8
                  step, all within Adam's 2·lr·iterations).
  fast_style_train
                  fast-style training at full width (the classic net, crop
                  224, b16, the family-2 encoder at truncate 8 with
                  --style_layers all, seeded weights), f32 and bf16: 8
                  steps of train_fast_style with exact launches (a step: 4
                  gram_fwd and 4 gram_bwd, 15 instance_norm_fwd and 15
                  instance_norm_bwd), the loss on one batch falling
                  tenfold, the encoder frozen; one f32 step's loss and
                  gradients on 4 of its images against the CPU (relative
                  L2 per leaf; the
                  biases whose true gradient is zero held to rounding
                  noise); a 3-style conditional net's step through
                  train_multi_style against the CPU; the CLI on 8 PNGs
                  (b4, 2 epochs), single style and a 2-style gallery, each
                  run uninterrupted twice and run with --resume
                  --checkpoint_every 1 (the gallery also
                  --async_checkpoint), stopped by a SIGTERM after 3
                  batches and resumed, held to the uninterrupted run;
                  serve_style --net on the gallery's net, one POST a
                  style; steps/s, images/s, busy, idle share and peak
                  memory of the b16 step.
  family2_train   family-2 training at full width (truncate 7, S 7, b32,
                  224² crops of 256² staged uint8, 4 classes, seeded
                  weights): one step's launches (3 pooled_gram_fwd and 3
                  pooled_gram_bwd; with the encoder frozen 3 and 0); one
                  f32 step on 8 rows of the batch against the CPU's in
                  float64 from the same
                  weights (the loss, every gradient leaf by relative L2
                  within 5e-3 or twice the CPU's f32 step's own error on
                  it, the running statistics); the CLI on 96 PNGs, 2 folds, 2
                  epochs, with exact launches and the reference's
                  artifacts, uninterrupted, then with --resume
                  --async_checkpoint stopped by a real SIGTERM and
                  resumed, equal to the first run bit for bit (both with
                  cuDNN's deterministic algorithms); its
                  best_global_model.npz through the family-2 eval CLI;
                  images/s, busy, idle share, kernel share and peak memory
                  of the b32 step, f32 and bf16.
  family1_train   family-1 training at full width (truncate 8, dim 256,
                  b32, 224² crops of 256² staged uint8, 4 classes, seeded
                  weights) with the identity and all 25 (geometric,
                  colour) combinations: each of the ten transforms, and the
                  26-combination batch, on the card against the CPU on the
                  same host-drawn parameters; one augmented f32 step on 8
                  rows against the CPU's in float64 (held as
                  family2_train's);
                  the CLI on 24 PNGs, 2 folds, 2 epochs, --geom_aug
                  --color_aug with 2 transforms each, uninterrupted and
                  once stopped by a real SIGTERM and resumed, equal to it
                  bit for bit (both with cuDNN's deterministic
                  algorithms); images/s, busy,
                  idle share and peak memory of the b32 step, augmented in
                  f32 and bf16 and with the identity in f32 (the
                  augmentation's cost); no hand-written launch.
  family3_train   family-3 training at the config defaults (patch sizes
                  10/70/150, ndf 64, 4 classes), b32, 224², norm "batch"
                  and "instance": one step's launches (13 instance_norm_fwd
                  and 13 instance_norm_bwd under "instance", none under
                  "batch"); one f32 step under each norm on 8 rows against
                  the CPU's;
                  the CLI on 32 PNGs, 2 folds, 2 epochs, norm "instance",
                  with exact launches and the reference's artifacts
                  (model_fold_<k>, retrained_performance.json,
                  retrained_hyperparameters.json); images/s, busy, idle
                  share and peak memory of the b32 step in f32 and bf16
                  under each norm. The kernel rows hold instance_norm_fwd
                  and instance_norm_bwd at the 13 norms' b32 shapes (no
                  ReLU, unit scale, zero bias), f32 and bf16.
  remat           each hand-written Function inside a remat block
                  (gram_fwd/gram_bwd, pooled_gram_fwd/bwd at S 7 and on the
                  project route, instance_norm_fwd/bwd): output and input
                  gradient bit-equal, one forward launch more; a b32
                  family-2 step (truncate 7) and a b32 family-3 step (norm
                  "instance") with and without --remat from the same
                  weights: loss, gradients, running statistics bit for bit
                  (cuDNN deterministic), less peak memory, launches; both
                  steps timed.
  family3_serve   serve_style --family multi_patchgan over HTTP, 224², norm
                  "instance" and "batch", rgb and yuv420, a POST each of 5
                  iterations: exact launches, each reply against the
                  service's job run again in process, ms a request; the
                  device I420 packer against cv2 and the CPU.
  dispatch        the family-1 classification CLI at --steps_per_dispatch
                  4 and 1 (metrics.txt byte-equal), its eval loop timed at
                  K = 1 and 4, a family-2 epoch at K = 4 and 1 (bit-equal).
  grad_accum      a family-3 (norm "instance") b32 step at --grad_accum 4
                  and the full batch against the full batch in float64 on
                  the CPU; a family-2 b32 step at --grad_accum 4 against a
                  hand-written micro-batch loop (bit-equal); both timed.
  profile_debug   --profile_dir on family 2's style transfer (the trace
                  names gram_fwd and gram_bwd); --debug_nans clean, and
                  with a NaN weight a CLI process exiting with
                  FloatingPointError.
  ema_mix         --ema_decay 0.999 --mixup 0.2 --cutmix 1.0: one
                  family-2 step on 8 rows (truncate 7, S 7; a CutMix key) and one
                  b8 family-3 step (norm "instance", --mixup alone)
                  against the CPU in float64 (the loss, every gradient and
                  every EMA leaf, the card's EMA its recurrence bit for
                  bit), with exact launches (3 + 3
                  pooled_gram_fwd/bwd, 13 + 13 instance_norm_fwd/bwd); the
                  family-2 CLI with the three flags on 96 PNGs (fold
                  checkpoints equal to the EMA trees, a SIGTERM and a
                  bit-equal resume); the b32 step with and without the
                  flags, f32 and bf16, timed.
  auto_batch      family 1's train CLI at full width with --auto_batch
                  --hbm_budget_gb 16: the probes' peaks rise, a larger
                  batch is adopted and saved, its first real step stays
                  under 95 % of the budget; the card's total memory.
  int8            family 1's PTQ on the card (2 b32 calibration batches):
                  int8 logits against the CPU's from the same q.npz,
                  features against f32 (cosine > 0.99), b32 images/s in
                  int8, f32 and bf16, 50 int8 camera frames; family 2's
                  int8 forward at b8 (4 pooled_gram_fwd) against the CPU;
                  the family-1 CLI with --precision int8 writing, then
                  loading, --quantized_path (metrics.txt byte-equal), and
                  --qat_steps 2.
  serve           ``cli/serve.start`` at full width, --batch_size 64:
                  family 1 (truncate 8, dim 256) in f32, bf16, int8
                  (calibrated on 32 PNGs, written to --quantized_path, then
                  a second start from that file alone, answering alike)
                  and yuv420, family 2 (truncate 8, S 7) and family 3 (the
                  train variant the JAX CLI serves, config defaults, norm
                  "instance") in f32; each run 256 raw POSTs from 128
                  threads in 4 client processes (every 8th frame 300x400),
                  every answer against the direct batched forward on the
                  padded batch its dispatcher formed (f32 within 1e-5,
                  bf16 2e-2, int8 1e-3, the argmax equal), /healthz,
                  /stats and /metrics; exact launches (family 2: 4
                  pooled_gram_fwd a batch, family 3: 13 instance_norm_fwd
                  a batch, family 1 none); images/s, p50 and p95, mean
                  occupancy, the card's busy share from the direct
                  forwards' time. Then ``--devices`` (``devices``): family
                  2 through two replicas on [cuda:0, cuda:0]
                  (``core.mesh.DeviceGroup``, a block of 32 rows each) in
                  rgb and yuv420, and a 2-device artifact (export batch
                  64) served on them, every answer against one replica's
                  on the same frames, 8 pooled_gram_fwd a batch, images/s
                  beside one replica's (one card: a correctness cell, not
                  a scaling one); and the style service's texture mode
                  (family 2, layers 5, b4, 5 iterations) on two replicas,
                  each with its own model from ``cli/serve_style``'s
                  builder, every job's pixels, loss and iterations against
                  one replica's, twice one replica's gram_fwd and gram_bwd
                  launches.
  recycle         --recycle_after_requests with the proxy's parent in a
                  child process of this script (which has initialised
                  CUDA): family 1 f32 at b16, recycled every 48 requests
                  under 140 POSTs from 32 threads, the worker killed once
                  with requests in it: 2 recycles, 1 crash, no failed
                  request, every answer within 1e-5 of in-process serving,
                  CUDA never initialised in the parent, each handover's
                  seconds; beside it serve_style texture mode (family 2,
                  layers 5, 5 iterations) through one recycle, each answer
                  against the service's job run here.
  artifact        serving artifacts (``deploy/artifact.py``): host us a
                  call of gram_fwd and instance_norm_fwd through their
                  torch.library ops and through the direct wrappers;
                  ``serve --export_artifact`` on the card for family 1 in
                  f32 (symbolic batch), bf16, int8 and yuv420, families 2
                  and 3 (norm "instance") in f32, each file loaded and
                  held at b1, b7 and b64 to the live forward (f32 1e-5,
                  bf16 2e-2, int8 1e-3), with 4 pooled_gram_fwd (family
                  2) or 13 instance_norm_fwd (family 3) a forward and the
                  graphs' hst nodes; ``serve --artifact`` (family 2) under
                  the serve phase's load, every answer against the direct
                  forward and the live model; --recycle_after_requests
                  with --artifact (one recycle) and a fresh interpreter's
                  start split into imports, CUDA context, load and first
                  forward, for the artifact and for the model;
                  ``serve_style --export_artifact``/``--artifact`` in
                  texture mode (family 2, layers 5, b2), for family 3
                  (norm "instance", b1) and content+style (b2), 5
                  iterations: iterations equal, uint8 within one level,
                  losses within 1e-5 or twice the live service's own
                  run-to-run spread, launches equal, one POST; a family-3
                  style iteration's host time through the ops and through
                  autograd.Functions that call the wrappers; and the
                  fast-style net (``--net``, b8) against the live net
                  job bit for bit, with 15 instance_norm_fwd a forward.
  style_int8      the style loop's weights_int8: the family-2 texture loop
                  (layers 5, b2, 224²) with and without it, image-
                  iterations/s; the int8 weights equal the CPU's, the
                  quantised Grams against the CPU and against f32.
  native_decode   whether the machine has g++ and jpeglib.h (a JSON line);
                  where it has, the native JPEG decoder built under
                  HST_NATIVE_DECODE=1 and HostLoader's images/s at b32
                  with it and with PIL, bit-equal batches; else PIL alone.
  parallel_folds  --parallel_folds: the seven hst ops under vmap on the
                  card (one launch for the folds); train_gram_attention
                  and train_multi_patchgan (norm "instance") at b32, 2
                  folds, one epoch, with and without the flag: weights
                  and losses, training launches the sequential count / 2;
                  the b32 steps' images/s both ways.
  data_parallel   data-parallel training (``--devices N`` and ``--zero1``,
                  ``core/mesh.py``, ``parallel/``): two gloo ranks spawned
                  on the one card (``create_mesh(devices=[cuda:0] * 2)``,
                  their collectives staged through host memory), family 2
                  at full width (truncate 7, S 7, b32 global, K2 and K2')
                  with and without --zero1 and family 3 (defaults, norm
                  "instance", K3 and K3'), 3 steps each against one rank
                  on the same global batches: losses and the parameter and
                  running-statistics trees within 1e-4, the moves within
                  PF_TOL_MOVE, or three times the one rank's own spread
                  (its batches' rows reversed) where that is larger,
                  ZeRO-1 within 1e-6 of plain data
                  parallelism at half its state bytes a rank, exact
                  launches on every rank; images/s and the collectives' ms
                  a step from a profile; then one NCCL rank (a one-rank
                  group on the card): one step equal to the plain step.
                  On the same two ranks, --parallel_folds over fold meshes
                  (family 2 at b32 a fold: K = 2 on fold 2 x data 1, K = 3
                  on fold 1 x data 2, the batch norms' collectives under
                  vmap), 2 steps against one device's fold step: within
                  1e-4 after the first, the shared fold states bit-equal
                  on both ranks, K2/K2' 3 + 3 a step on each rank.
                  On the same two ranks, the model axis
                  (``parallel/sharding.py``'s factories): family 2 at its
                  defaults (b32) on make_mesh_2d(2) (TP: the classifier's
                  rows split), FSDP on a data mesh of 2, and
                  make_mesh_3d(2) = (1, 1, 2) (rows in two bands, K2 and
                  K2' on each) plain and under ZeRO-1, MA_STEPS steps against
                  one rank: within 1e-4 after the first step, the
                  replicated leaves bit-equal on both ranks, K2/K2' 3 + 3
                  a step on each rank; images/s, peak memory and the
                  bytes a rank stores.
                  On the same two ranks, sharded checkpoints
                  (``checkpoint/sharded_io.py``): family 2 at its defaults
                  under FSDP, the state after step 2 saved by the
                  asynchronous writer while step 3 runs, each rank's
                  reload bit-equal, the checkpoint resumed on one device
                  in the parent, its step 3 within 1e-4 of the ranks'
                  (elastic 2 -> 1); bytes a rank wrote, submit-to-commit
                  and load seconds. And the loader's multi-host stride
                  (``HostLoader(process_index=, process_count=)``,
                  ``global_batch_dict``): one family-2 step of the two
                  ranks against one device on their batches concatenated.
                  On the same two ranks, the evaluation paths of
                  ``--devices N`` through the evaluation CLIs' task
                  functions on 63 PNGs (``cli/_common.eval_loader``, a
                  rank decoding its rows): family 1 at b32 through
                  ``evaluate_classification``, its embeddings
                  (``compute_embeddings_with_paths``) and
                  ``run_inference``; family 2 at b8 through its CLI's
                  ``run_classification`` (the JSON rank 0 writes) and
                  ``evaluate_classification``; family 3 ("instance") at
                  b32 through its CLI's ``evaluate``: losses,
                  probabilities, predictions, labels, embeddings and
                  paths gathered, against one rank; the
                  family-2 texture loop (layers 5, b4) with rank 0's rows
                  stopping at the first iteration and rank 1's at the
                  cap: iterations and final losses against one rank;
                  each rank's launches (4 pooled_gram_fwd, or 13
                  instance_norm_fwd and 16 gram_fwd, a forward; a gram_fwd
                  and a gram_bwd an iteration) and images/s beside one
                  rank's.
                  These are not multi-card scaling numbers.
  spatial         --shard_spatial (``parallel/spatial.py``): the four banded
                  K3/K3' entry points (instance_norm_band_stats, _apply,
                  _bwd_reduce, _bwd_apply) on the two bands of family 3's
                  b1 maps (1,112,112,64) to (1,14,14,512), ReLU, f32 and
                  bf16, each against its plain version and the bands' y
                  and dx against the unbanded kernels on the whole map,
                  timed with their plain versions and bounds; then two
                  gloo ranks sharing card 0 with a spatial axis of 2
                  (``create_mesh(spatial=2)``), beside one device here,
                  both under cuDNN's deterministic algorithms, through the
                  task functions at 224², b1, 3 iterations: the family-2
                  texture loop through layer4, the content+style loop
                  (every stage's Gram, TV) and family 3 (defaults,
                  "instance"), each rank's final losses within 1e-4 of
                  one device's and rank 0's PNGs against one device's;
                  make_spatial_eval_step of family 1 (b2) within 1e-5;
                  each band entry point, K1 and K1' launched on each rank
                  and no unbanded K3/K3' on a band; image-iterations/s of
                  the ranks beside one device (a correctness cell, the
                  ranks share the card).
  Family 1 and its camera launch no hand-written kernel (their convs,
  norms and pools are cuDNN work, and so is Grad-CAM's gradient): a launch
  there fails the run.

Launch counts are set to 0 just before each main-path phase and read just
after; a kernel of the phase that never launched fails the run, as does any
kernel that disagrees with its plain version beyond the stated tolerance.
Prints, before the phases, whether the machine has tensorstore (a JSON
line, nothing gated on it). Prints one JSON line of kernel records, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
when CUDA is absent or the port's package is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "heuristique_style_transfer_code_tpu_torch"
SOURCE = {"gram": f"{PKG}/csrc/gram.cu", "instance_norm": f"{PKG}/csrc/instance_norm.cu"}
PALLAS = "heuristique_style_transfer_code_tpu/ops/pallas/gram_kernel.py"
PALLAS_IN = "heuristique_style_transfer_code_tpu/ops/pallas/instance_norm_kernel.py"

# Dense peak rates of the H100 SXM (NVIDIA data sheet), the card whose name
# this is: bytes/s of device memory, FLOP/s of f32 outside the tensor cores
# (the kernels do not use TF32) and of bf16 on the tensor cores. Bounds on
# any other card would need its own row, so the run refuses it.
PEAKS_CARD = "H100 80GB HBM3"
PEAKS = (3.35e12, 67e12, 989e12)

# Both max|err| / max|plain| and ||err|| / ||plain|| (RMS) must stay under it.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# instance_norm_fwd: (max, RMS) bounds of the same two relative errors
TOL_IN = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-3)}

GRAM_SHAPES = [(4, 56, 56, 64), (4, 56, 56, 256), (4, 7, 7, 2048)]  # layers 4, 5, 8
# the content+style loop's stage Grams at --style_layers all --layers 8 that
# GRAM_SHAPES lacks: layer2's and layer3's outputs (gram_fwd and gram_bwd)
STAGE_GRAM_SHAPES = [(4, 28, 28, 512), (4, 14, 14, 1024)]
# gram_fwd only: C not a multiple of 64, HW not of 64 (TMA's zero fill, the
# clipped stores, a partial diagonal tile)
RAGGED_GRAM_SHAPES = [(1, 13, 11, 200), (2, 7, 7, 48)]
POOLED_SHAPES = [(8, 56, 56, 256), (8, 28, 28, 512), (8, 14, 14, 1024), (8, 7, 7, 2048)]
POOL_S = 7
# pooled_gram_fwd only, (shape, S): C % S != 0 at odd HW; C % 4 != 0 (the
# scalar-load path) at the largest S; C < S (a channel in several bins)
RAGGED_POOLED = [((2, 13, 11, 200), 7), ((1, 9, 7, 203), 16), ((2, 5, 5, 5), 7)]
# gram_bwd only: C not a multiple of 64 at HW 143 and 49, and C % 8 != 0
# (bf16 then takes the FFMA route, f32 its scalar loads)
RAGGED_BWD_SHAPES = [(1, 13, 11, 200), (2, 7, 7, 48), (1, 9, 7, 203)]
# pooled_gram_fwd past 16 bins (the "project" route): layer4, C % S != 0 at
# odd HW, and C < S
LARGE_S_POOLED = [((8, 7, 7, 2048), 24), ((2, 13, 11, 200), 24), ((2, 5, 5, 5), 20)]
# gram_fwd at the family-3 Gram's shape (HW = 16 pooled positions, C = the
# gram dim 64), at the classification batch and at the camera's b1
F3_GRAM_SHAPES = [(32, 4, 4, 64), (1, 4, 4, 64)]
# pooled_gram_fwd at the family-2 camera's b1 (layer1's output)
F2_CAMERA_POOLED = [((1, 56, 56, 256), 7)]
# instance_norm_fwd at family-3 shapes under norm "instance" (unit scale,
# zero bias, ReLU): more images than the clusters the card holds at once,
# and C > 256 (the split route) at B = 32 and at the camera's B = 1
F3_IN_SHAPES = [(32, 112, 112, 64), (32, 28, 28, 256), (32, 14, 14, 512), (32, 13, 13, 1024),
                (1, 13, 13, 1024)]
# gram_bwd at the family-3 style loop's Gram (16 an iteration, b1)
F3_BWD_SHAPES = [(1, 4, 4, 64)]
# instance_norm_bwd at the family-3 style loop's 13 norms (b1, norm
# "instance"; the distinct shapes, with ReLU, unit scale, zero bias) and at
# b32, and at the fast-style net's shapes with affine rows that differ
F3_STYLE_IN_SHAPES = [(1, 112, 112, 64), (1, 56, 56, 128), (1, 55, 55, 256), (1, 28, 28, 256),
                      (1, 14, 14, 512), (1, 13, 13, 1024), (32, 112, 112, 64)]
NET_IN_BWD_SHAPES = [(8, 224, 224, 32), (8, 56, 56, 128)]
# pooled_gram_bwd (family-2 training): the b32 stage outputs at truncate 7,
# S 7 (layer1..layer3); overlapping bins at C = 10 (a boundary channel in
# two bins); C < S (a channel in several bins); past 16 bins; its largest
# S, 64; odd C (the scalar store path)
B32_POOLED_SHAPES = [(32, 56, 56, 256), (32, 28, 28, 512), (32, 14, 14, 1024)]
POOLED_BWD_EXTRA = [((2, 13, 11, 10), 7), ((2, 5, 5, 5), 7), ((2, 13, 11, 200), 24),
                    ((4, 14, 14, 1024), 64), ((2, 13, 11, 203), 7)]
# pooled_gram_fwd's Y (the backward's input) on each route: "bulk" at the
# classification shape and the b32 stage shapes, "scalar" (C % 4 != 0, and
# C < S), "project" (S > 16)
POOLED_Y_CASES = ([((8, 56, 56, 256), 7)] + [(shape, 7) for shape in B32_POOLED_SHAPES]
                  + [((1, 9, 7, 203), 16), ((2, 5, 5, 5), 7), ((2, 13, 11, 200), 24),
                     ((8, 7, 7, 2048), 24)])
# fast-style training at b16: the frozen encoder's four stage Grams on the
# stylised output (gram_fwd and gram_bwd), and the net's norms (in1 and
# in_up2, in2 and in_up1, in3 and the residual blocks': three distinct
# shapes, with ReLU and, in the blocks' second norms, without)
B16_GRAM_SHAPES = [(16, 56, 56, 256), (16, 28, 28, 512), (16, 14, 14, 1024), (16, 7, 7, 2048)]
B16_IN_SHAPES = [(16, 224, 224, 32), (16, 112, 112, 64), (16, 56, 56, 128)]
# the family-3 style loop: b1 (the CLI's loader), 2 images, 20 iterations;
# each iteration launches 16 gram_fwd and 16 gram_bwd and, under norm
# "instance", 13 instance_norm_fwd and 13 instance_norm_bwd; each image's
# target forward 16 gram_fwd (and 13 instance_norm_fwd)
F3_STYLE_IMAGES, F3_STYLE_ITERS, F3_STYLE_LR = 2, 20, 0.01
F3_STYLE_CPU_ITERS = 10  # the card-vs-CPU loop on image 0
# with seeded weights an image's own Gram gives a loss of about 1e-11 and a
# pixel gradient near 1e-15, far below Adam's eps (1e-8): the pixels would
# not move. The card-vs-CPU loop chases the image's Gram plus this many
# times a seeded symmetric unit offset instead, where the gradient is
# about eps (RMS) at full width and each step moves pixels by up to lr
F3_STYLE_OFFSET = 100.0
# relative size of the nudge to the CPU loop's starting noise that measures
# the loop's own spread (the f32 yardstick of the card's pixel change)
F3_STYLE_NUDGE = 1e-7
DEVICE = "cuda"
N_IMAGES, STYLE_ITERS = 16, 20
# the main-path shapes that the kernel records report
MAIN_SHAPE = {"gram_fwd": (4, 56, 56, 256), "gram_bwd": (4, 56, 56, 256),
              "pooled_gram_fwd": (8, 56, 56, 256), "pooled_gram_bwd": (32, 56, 56, 256),
              "instance_norm_fwd": (8, 224, 224, 32), "instance_norm_bwd": (1, 112, 112, 64),
              # rank 0's band of the family-3 loop's first map (1, 112, 112, 64) at spatial 2
              **{k: (1, 56 * 112, 64) for k in ("instance_norm_band_stats",
                                                 "instance_norm_band_apply",
                                                 "instance_norm_band_bwd_reduce",
                                                 "instance_norm_band_bwd_apply")}}
# the fast-style net's norms at crop 224, width 32, batch 8: in1 and in_up2,
# in2 and in_up1, in3 and the residual blocks' 10
IN_SHAPES = [(8, 224, 224, 32), (8, 112, 112, 64), (8, 56, 56, 128)]
# in1's shape at the smaller sizes of a --batch_size ladder
LADDER_IN_SHAPES = [(1, 224, 224, 32), (4, 224, 224, 32)]
NORMS_PER_FORWARD = 15
N_REQUESTS, REQUEST_THREADS = 16, 8
# family 1 at full width: truncate 8, dim 256, 4 classes, the CLI's batch
F1_TRUNCATE, F1_DIM, F1_CLASSES, F1_BATCH = 8, 256, 4, 32
F1_IMAGES, F1_INFER_IMAGES, CAMERA_FRAMES, VIDEO_FRAMES = 128, 40, 100, 30
# family 3 at full width: the config defaults (patch sizes 10/70/150, ndf
# 64, gram dim 64, 4 classes), the CLI's batch 32; a forward runs 16 convs
# (so 16 Grams) and, under norm "instance", 13 instance norms
F3_BATCH, F3_BATCHES, F3_INSTANCE_BATCHES, F3_GRAMS, F3_NORMS = 32, 4, 2, 16, 13
F2_BATCH, EMBED_BATCHES, F3_CAMERA_FRAMES = 8, 2, 50
# Grad-CAM through family 1's CLI: 8 images in b4 batches; CAMs timed at b1
GRADCAM_IMAGES, GRADCAM_BATCH, GRADCAM_TIMED = 8, 4, 10
# the content+style loop (family 2, --layers 8 --style_layers all: 4 stage
# Grams an iteration): b4, 20 iterations; the server: 5 iterations, 8 POSTs
CS_BATCH, CS_ITERS, CS_SERVE_ITERS, CS_SERVE_REQUESTS = 4, 20, 5, 8
# fast-style training at full width: the classic net, crop 224, the CLI's
# batch 16, the family-2 encoder at truncate 8 with --style_layers all;
# 8 steps of train_fast_style on one batch, 10 timed steps; the
# CLI at b4 over 8 images, 2 epochs
FST_BATCH, FST_CROP, FST_STEPS, FST_TIMED, FST_CLI_BATCH = 16, 224, 8, 10, 4
FST_CPU_ROWS = 4  # the card-vs-CPU step takes this many rows of the batch
# one training step, card vs CPU (f32): the loss, relative; each gradient
# leaf's relative L2 error, where a pre-ReLU activation within f32 rounding
# of zero can switch a local part of the data gradient; and the noise of
# the biases whose true gradient is zero, relative to the largest gradient
FST_TOL_LOSS, FST_TOL_GRAD, FST_TOL_NOISE = 1e-4, 1e-2, 1e-4
# the relative nudge of the CPU net's weights that measures the CPU step's
# own gradient spread (the card's loss lies about 6e-6 from the CPU's)
FST_NUDGE = 1e-6
# a resumed fit on the card against an uninterrupted one: parameters' RMS
# gap per leaf as a share of steps · lr (Adam's largest move), final loss;
# each raised to twice the gap between two uninterrupted runs where that
# is larger
FST_TOL_RESUME, FST_TOL_RESUME_LOSS = 0.25, 1e-2
# card vs CPU on the family-3 and embedding phases, each relative to the
# CPU result's own scale: (max, RMS); f32 sums run in other orders (cuDNN
# vs oneDNN) through up to 8 convs and 3 norms; bf16 rounds each stage's
# output at 2^-8 on both sides, at other places
TOL_MODEL = {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 2e-2)}


# family-2 training at full width: truncate 7, S 7, the CLI's batch 32, 224²
# crops, 4 classes x 24 PNGs (2 folds: 48 train images a fold, 2 batches an
# epoch), 2 epochs; the step timed over F2T_TIMED steps, profiled over 3
F2T_TRUNCATE, F2T_S, F2T_BATCH, F2T_PER_CLASS, F2T_TIMED = 7, 7, 32, 24, 5
F2T_LR = 0.01
# one b32 f32 step on the card against the same step on the CPU in float64:
# the loss, relative; each gradient leaf by relative L2 within F2T_TOL_GRAD
# or, where that is larger, twice the error of the same step on the CPU in
# f32 against float64 (the train-mode batch norms' backward amplifies
# rounding toward the first stages of the ResNet encoder: there any f32
# step, the card's or the CPU's, lies 1-3e-2 from float64 at every leaf);
# the running statistics after the step, relative to each leaf's largest
# entry
F2T_TOL_LOSS, F2T_TOL_GRAD, F2T_TOL_STATS = 1e-4, 5e-3, 1e-4
# the training phases' card-vs-CPU steps take this many rows of the b32
# batch (the CPU's float64 step is the smoke's costliest host work)
CPU_CHECK_ROWS = 4

# family-1 training at full width: truncate 8, dim 256, the CLI's batch 32,
# 224² crops of 256² staged uint8, 4 classes; the identity and all 5 x 5
# (geometric, colour) combinations; the CLI on 4 classes x 6 PNGs with 2
# geometric and 2 colour transforms picked (4 combinations), 2 folds, 2
# epochs; the step timed over F1T_TIMED steps, profiled over 3
F1T_BATCH, F1T_PER_CLASS, F1T_TIMED, F1T_LR = 32, 6, 5, 0.01
# a transform on the card against the same code on the CPU, same
# parameters: max |difference| of the normalised output (the gathers pick
# the same pixels; FMA contraction differs, about 1e-6 a step)
F1T_TOL_AUG = 1e-4
# family-3 training at the config defaults (patch sizes 10/70/150, ndf 64,
# 4 classes), b32, 224²; the CLI on 4 classes x 8 PNGs, 2 folds, 2 epochs
F3T_BATCH, F3T_PER_CLASS, F3T_TIMED, F3T_LR = 32, 8, 5, 0.01
# the train-variant discriminators' 13 instance norms a forward at b32 (no
# ReLU: a separate LeakyReLU follows; unit scale, zero bias): small (224²
# in), medium (112²), large (56²), from discriminator_layer_plan
F3T_IN_SHAPES = [(32, 112, 112, 64), (32, 56, 56, 128), (32, 55, 55, 256),
                 (32, 56, 56, 64), (32, 28, 28, 128), (32, 14, 14, 256), (32, 7, 7, 512),
                 (32, 6, 6, 1024),
                 (32, 28, 28, 64), (32, 14, 14, 128), (32, 7, 7, 256), (32, 3, 3, 512),
                 (32, 2, 2, 1024)]

# remat: one b32 step with and without --remat, families 2 and 3;
# each gradient leaf by relative L2 within REMAT_TOL_GRAD (the same cuDNN
# ops run again under cuDNN's deterministic algorithms), the running
# statistics bit for bit; REMAT_TIMED timed steps each (also --grad_accum's)
REMAT_TOL_GRAD, REMAT_TIMED = 1e-5, 3
# the Functions inside a remat block: (name, shape, S): K1, K2 at S 7 and on
# its projection route (S 24), K3 with ReLU
REMAT_FN_CASES = [("gram", (4, 56, 56, 256), None), ("pooled_gram", (8, 56, 56, 256), 7),
                  ("pooled_gram", (8, 7, 7, 2048), 24), ("instance_norm", (8, 112, 112, 64), None)]
# family-3 serving: iterations a request (threshold 0) and POSTs per norm and transport
F3S_ITERS, F3S_REQUESTS = 5, 1
# --steps_per_dispatch: K; family-1 eval batches timed; family-2 train batches
DISPATCH_K, DISPATCH_EVAL_BATCHES, DISPATCH_TRAIN_BATCHES = 4, 4, 5
# --grad_accum: micro-batches of a b32 step; family 3 (no batch statistics)
# against the full batch in float64, each leaf's move by relative L2 within
# max(ACCUM_TOL, 2x the card's f32 full-batch step's worst leaf): the
# weight gradients after an instance norm cancel, and both f32 steps lie
# up to 5.6e-3 from float64 on the H100
ACCUM_K, ACCUM_TOL = 4, 1e-3
# ema_mix: family 2 at the config defaults (and family 3 at norm "instance")
# under --ema_decay 0.999 --mixup 0.2 --cutmix 1.0; the CLI on family2_train's
# 96 PNGs, 2 folds x 2 epochs
EMA_DECAY, MIXUP, CUTMIX = 0.999, 0.2, 1.0
# the family-3 mixed step against the CPU runs on the first 8 images
EM_F3_CPU_BATCH = 8
# auto_batch: family 1's train CLI (truncate 8, dim 256, configured b32)
# under a 16 GiB budget, on 4 classes x 6 PNGs, 2 folds, 1 epoch
AB_BUDGET_GB, AB_PER_CLASS = 16.0, 6
# int8: family 1 calibrated on 2 b32 batches; 10 timed b32 forwards; 50 b1
# camera frames; family 2 at b8; the CLI on 4 classes x 8 train PNGs (and
# 4 test); card vs CPU int8 logits (and camera probabilities) within 1e-3,
# the int8 test's tolerance
INT8_CAL_BATCHES, INT8_TIMED, INT8_CAMERA_FRAMES, INT8_F2_BATCH = 2, 10, 50, 8
INT8_CLI_PER_CLASS, INT8_TOL_LOGITS = 8, 1e-3
# serve: cli/serve.start at full width, --batch_size 64; SERVE_REQUESTS raw
# POSTs a run from SERVE_CLIENTS threads (two batches' worth) spread over
# SERVE_CLIENT_PROCS client processes, so that the load does not share the
# server's GIL, after SERVE_WARM untimed ones (every SERVE_OVERSIZED-th
# frame 300x400, downscaled in submit); each
# answer against the direct batched
# forward on its padded batch, max |dprob|: f32 within 1e-5, bf16 within
# TOL's 2e-2, int8 within the int8 phase's 1e-3, the argmax equal; the
# int8 calibration folder holds SERVE_CAL_PER_CLASS PNGs a class
SERVE_BATCH, SERVE_REQUESTS, SERVE_CLIENTS, SERVE_OVERSIZED = 64, 256, 128, 8
SERVE_CLIENT_PROCS, SERVE_WARM = 4, 16
SERVE_TOL = {"float32": 1e-5, "bf16": 2e-2, "int8": 1e-3}
SERVE_CAL_PER_CLASS = 8
# recycle: family 1 f32 served through --recycle_after_requests in a child
# process of this script (which has initialised CUDA, so it cannot be the
# proxy's parent): RECYCLE_REQUESTS POSTs from RECYCLE_CLIENTS threads at
# batch RECYCLE_BATCH, two recycles and one worker killed with requests in
# it (4 workers); then serve_style texture mode (family 2, layers 5, 5
# iterations) through one recycle with 3 POSTs
RECYCLE_AFTER, RECYCLE_REQUESTS, RECYCLE_CLIENTS, RECYCLE_BATCH = 48, 140, 32, 16
RECYCLE_KILL_AFTER, RECYCLE_STYLE_ITERS, RECYCLE_STYLE_LR = 100, 5, 0.01
# a request may wait through a handover (a worker's start: 10-20 s on the
# card's machine), longer than the CLI's default --request_timeout of 30 s
RECYCLE_TIMEOUT_S = 300
# the artifact phase: the batches each inference artifact is checked at, the
# style artifacts' iterations, the calls timed a host cost, and
# --recycle_after_requests with --artifact (every ART_RECYCLE_AFTER of
# ART_RECYCLE_REQUESTS requests); the exports' time limit
ART_BATCHES, ART_STYLE_ITERS, ART_OVERHEAD_CALLS = (1, 7, 64), 3, 2000
ART_EXPORT_TIMEOUT_S = 600
ART_RECYCLE_AFTER, ART_RECYCLE_REQUESTS = 24, 40
# a style artifact's per-image losses against the live service's, relative:
# this, or twice the live service's own run-to-run spread (cuDNN's backward
# algorithms may sum in another order from one run to the next)
ART_STYLE_LOSS_RTOL = 1e-5
# the fast-style net's artifact (serve_style --net --export_artifact) at the
# fast_style phase's larger batch
ART_NET_BATCH = 8
# style_int8: the family-2 texture loop at serve_style's texture job shape
# (layers 5, b2, 224²), SI8_ITERS iterations, SI8_RUNS timed runs a side
SI8_BATCH, SI8_ITERS, SI8_RUNS = 2, 20, 1
# native_decode: HostLoader at b32 over ND_IMAGES JPEGs of ND_SIZE (h, w),
# ND_EPOCHS epochs a decoder
ND_IMAGES, ND_SIZE, ND_BATCH, ND_EPOCHS = 256, (480, 640), 32, 3
# parallel_folds: K folds; the CLIs at b32 on 4 classes x PF_PER_CLASS PNGs
# (2 steps a fold, one epoch), the steps timed over PF_TIMED rounds; an op
# under vmap against the same kernel fold by fold, max |difference| over the
# result's scale (the kernels plan their splits by the batch); fold-parallel
# against sequential training: each fold's move from its init (every leaf
# of its checkpoint) by relative L2, each printed batch loss (4 decimals) by
# absolute gap. The two runs' convolutions are different cuDNN kernels
# (grouped ones under the flag), and an f32 step's gradients at the stem's
# batch-norm leaves lie 1-3e-2 from float64 on the card (F2T_TOL_GRAD's
# note), so single leaves are printed, not gated; the CPU tests hold the
# same code to 1e-12 in float64
PF_K, PF_BATCH, PF_PER_CLASS, PF_TIMED = 2, 32, 32, 2
PF_TOL_OP, PF_TOL_MOVE, PF_TOL_LOSS = 1e-5, 1e-2, 2e-4
# data_parallel: DP_RANKS gloo ranks on the one card against one rank,
# DP_STEPS steps of the b{DP_BATCH} global batch a run, whose halves (one a
# rank) are dark and bright, so statistics of one rank's rows would miss.
# After the first step the loss and the parameter and statistics trees
# (values, whole-tree relative L2) lie within DP_TOL of one rank's and the
# moves from the init within PF_TOL_MOVE; after DP_STEPS steps the losses
# and trees within DP_TOL, the moves within PF_TOL_MOVE (the CPU tests hold
# the same code to 1e-10 in float64), ZeRO-1 within
# DP_TOL_ZERO1 of plain data parallelism (the same ops under cuDNN's
# deterministic algorithms); the ranks' start and runs within DP_TIMEOUT_S
DP_RANKS, DP_BATCH, DP_STEPS, DP_LR = 2, 32, 3, 0.01
DP_TOL, DP_TOL_ZERO1, DP_TIMEOUT_S = 1e-4, 1e-6, 240
# ...or, after DP_STEPS steps, within DP_SPREAD times the one rank's own
# spread where that is larger: the same run on each batch's rows reversed (the same sums in
# another order). Family 2's f32 steps are chaotic at these weights: on
# the CPU one device alone, 4 threads against 1, ends 3 steps with its
# moves 0.18 apart and its statistics 8.6e-4 (the layer-1 batch norms)
DP_SPREAD = 3.0
# data_parallel's fold-mesh cases (--parallel_folds --devices N) on the same
# two ranks: family 2 (truncate 7, S 7) at b{DP_BATCH} a fold, f32,
# PFM_STEPS steps of K folds from seeded inits (each fold's batches dark
# and bright by halves), under cuDNN's deterministic algorithms, on each
# (K, fold, data) of PFM_CASES: K = 2 on fold 2 x data 1 (a fold a rank)
# and K = 3 on fold 1 x data 2 (16 rows a rank, the three folds vmapped on
# each: the batch norms' collectives under vmap). Against one device's
# --parallel_folds step on the same batches: after the first step each
# fold's loss and parameter and statistics trees within DP_TOL and its
# moves within PF_TOL_MOVE (or DP_SPREAD times one device's own spread,
# the batches' rows reversed), after the last within DP_TOL or DP_SPREAD
# times that spread; every rank's K2/K2' launches 3 + 3 a step (one folded
# launch for its folds) and the shared fold states bit-equal on both ranks
PFM_CASES, PFM_STEPS = ((2, 2, 1), (3, 1, 2)), 2
# data_parallel's model-axis cases (parallel/sharding.py's factories) on the
# same two ranks: family 2 at its config defaults (truncate 7, S 7,
# b{DP_BATCH} global, 224 crop, f32) from the data_parallel runs' seeded
# weights and batches, MA_STEPS steps under cuDNN's deterministic
# algorithms, on each (name, mesh, factory) of MA_CASES: "tp" the (data 1,
# model 2) mesh of make_mesh_2d(2) (the classifier's rows split), "fsdp" a
# data mesh of 2 (parameters and momentum 1/2 a rank), "3d" and "3d_zero1"
# make_mesh_3d(2) = (1, 1, 2) (each image's rows in two bands, K2 and K2'
# on each band). Against the one-rank f2 run: after the first step the
# loss and the parameter and statistics trees within DP_TOL and the moves
# within PF_TOL_MOVE (or DP_SPREAD times one rank's own spread); the later
# losses printed beside one rank's, not gated: these f32 steps are chaotic
# (DP_SPREAD's note), and the banded convolutions round otherwise than the
# whole image's, which the rows-reversed spread does not cover (the CPU
# tests hold the same code to 1e-9 in float64 after two steps); each
# rank's K2/K2' launches 3 + 3 a step; every leaf the mesh replicates
# bit-equal on both ranks, and the gathered trees too
MA_CASES = (("tp", "2d", "sharded"), ("fsdp", "data", "fsdp"), ("3d", "3d", "sharded"),
            ("3d_zero1", "3d", "zero1"))
MA_STEPS = 2
# data_parallel's sharded-checkpoint case (checkpoint/sharded_io.py) on the
# same two ranks: family 2 at its config defaults (b{DP_BATCH} global, 224
# crop, S 7, f32) under FSDP on a data mesh of 2, from the data_parallel
# runs' seeded weights and batches, under cuDNN's deterministic algorithms.
# After step 2 each rank submits its state tree to
# make_async_sharded_writer and runs step 3 at once, then waits; the state
# after step 3 goes to a second directory, synchronously. Each rank reloads
# the first under its own layout, bit-equal to the host copy it kept before
# step 3. The parent restores the first, read whole, into a one-device
# model and state on the card, runs step 3 on the same global batch and
# holds its loss and its parameter, statistics and momentum trees within
# DP_TOL of the second (the elastic handoff 2 -> 1). K2/K2' 3 + 3 a step
# on each rank (3 steps) and in the resumed step.
SC_STEPS = 3
# data_parallel's loader-stride case: each rank draws the first batch of
# HostLoader(process_index=its data index, process_count=2) over the
# evaluation cases' 63 PNGs (shuffled, seed SC_SEED, b{DP_BATCH} // 2 a
# rank), takes it through global_batch_dict and runs one plain
# data-parallel family-2 step on it; the parent runs one device on the two
# local batches concatenated: the loss and the trees within DP_TOL, K2/K2'
# 3 + 3 on each rank and on one device.
SC_SEED = 127
# data_parallel's evaluation cases (``--devices N`` on the evaluation CLIs'
# task functions, ``_eval_runs``) on the same two ranks: family 1 (full
# width) at b{DPE_F1_BATCH}, family 2 (truncate 8, S 7) at b{DPE_F2_BATCH},
# family 3 (defaults, norm "instance") at b{DPE_F3_BATCH}, DPE_BATCHES
# batches each, the last with one pad row; the probabilities within
# DPE_TOL of one rank's (the loss and the embeddings relative), the
# argmax, predictions, labels, paths and the family-2 JSON's precision,
# recall and F1 equal (its AUC needs scikit-learn, which the card's
# machine lacks). The family-2 texture loop (layers
# 5) at b{DPE_LOOP_BATCH}, DPE_ITERS iterations, whose rank-0 rows start
# near their targets: a threshold between the rows' first losses stops
# rank 0's rows at the first iteration while rank 1's run to the cap; the
# iteration count equal to one rank's and the final losses within DPE_TOL
# relative of one rank on the same b2 blocks (``drive_masked_adam_blocks``:
# the ranks' arithmetic without their collectives), and of one rank at b4,
# or within DP_SPREAD times that one-rank run's own run-to-run gap and its
# b2 blocks' gap to b4 (cuDNN's f32 convolutions at another batch size),
# where those are larger. A row that stops near its target has gradients
# near Adam's eps, which its first step divides by: its loss carries any
# rounding of the gradient, so the loop runs under cuDNN's deterministic
# algorithms
DPE_F1_BATCH, DPE_F2_BATCH, DPE_F3_BATCH, DPE_BATCHES = 32, 8, 32, 2
DPE_LOOP_BATCH, DPE_ITERS, DPE_NEAR, DPE_TOL = 4, 5, 0.1, 1e-5
# serve's devices piece: family 2 (truncate 8, S 7) through two replicas
# on card 0 at b{SERVE_BATCH}, rgb and yuv420, and a 2-device artifact
# (--export_batch {SERVE_BATCH}); SD_FRAMES frames each, every answer
# within SERVE_TOL of one replica's on the same frames. Then the style
# service's texture mode on two replicas at b{SD_STYLE_BATCH},
# SD_STYLE_ITERS iterations under cuDNN's deterministic algorithms: each
# job's loss within DPE_TOL relative of one replica's (a b2 block against
# b4), its pixels within one uint8 level, its iterations equal
SD_FRAMES, SD_THREADS, SD_STYLE_BATCH, SD_STYLE_ITERS = 256, 32, 4, 5
# spatial (--shard_spatial): SP_RANKS gloo ranks on card 0 with a spatial
# axis of SP_RANKS (a 1 x 2 mesh, create_mesh(devices=[cuda:0] * 2,
# spatial=2), every collective staged through host memory) against one
# device, both under cuDNN's deterministic algorithms, through the task
# functions at 224² crops of 256² uint8, b1, SP_ITERS iterations, threshold
# 0: the family-2 texture loop (truncate 8, layers 8: through layer4, whose
# 7 rows are 4 + 3 a rank), the content+style loop (every stage's Gram, TV
# 0.1, from the content) and family 3 (the config defaults, norm
# "instance"); and make_spatial_eval_step of family 1 (truncate 8, dim 256,
# b2). Each loop's final per-image loss within SP_TOL_LOSS relative of one
# device's, its PNG within Adam's bound and 99% of it within one uint8
# level, the iterations equal; the logits within SP_TOL_LOGITS of their
# scale. A band's sums (the Grams,
# the norms' statistics, the content and TV terms) are added in another
# order than one device's, about 1e-7 relative a sum in f32.
SP_RANKS, SP_ITERS, SP_TIMEOUT_S = 2, 3, 300
SP_TOL_LOSS, SP_TOL_LOGITS = 1e-4, 1e-5
# the banded K3/K3' entry points on the two bands of family 3's b1 maps
# under norm "instance" (its first discriminator's four normed convs at
# 224²), ReLU, f32 and bf16: each entry point against its plain version on
# the same band (relative to the output's scale), and the bands' y and dx
# put together against the unbanded kernels' on the whole map
SP_IN_SHAPES = [(1, 112, 112, 64), (1, 56, 56, 128), (1, 28, 28, 256), (1, 14, 14, 512)]
SP_TOL_IN = {"float32": 1e-5, "bfloat16": 1e-2}


def _require(ok: bool, what: str) -> None:
    """A failed check ends the run (unlike ``assert``, also under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _peaks(name: str):
    if PEAKS_CARD not in name:
        raise RuntimeError(f"chip_smoke knows the peak rates of the {PEAKS_CARD} only, "
                           f"not of {name!r}")
    return PEAKS


def _time_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between two events. The graph takes
    the host (Python, ctypes, allocator) out of the measurement, which
    eager back-to-back launches of a few-microsecond kernel would time
    instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: library handles, the build, workspaces
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _bound(flops: float, nbytes: float, dtype, peaks):
    import torch

    mem, f32, bf16 = peaks
    t_ops = flops / (bf16 if dtype == torch.bfloat16 else f32)
    t_bytes = nbytes / mem
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(kg, peaks) -> dict:
    """Every kernel against its plain version, f32 and bf16, at the main
    path's shapes; returns {kernel: [row per shape and dtype]}."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {name: [] for name in kg.KERNELS}

    def check(got, want, dtype):
        """Max and RMS error, each relative to the plain result's own scale.
        The RMS one weighs every entry alike, so a wrong off-diagonal block
        fails it even where the diagonal dominates max|plain|."""
        torch.cuda.synchronize()
        diff = got.float() - want.float()
        err = diff.abs().max().item()
        rel = err / want.float().abs().max().item()
        rms = (diff.norm() / want.float().norm()).item()
        tol = TOL[str(dtype).split(".")[1]]
        ok = bool(torch.isfinite(got.float()).all()) and rel <= tol and rms <= tol
        return err, rel, rms, ok

    def features(shape, dtype, generator=gen):
        """Post-ReLU-like features: non-negative, so the Gram's off-diagonal
        entries are of the same order as its diagonal."""
        return torch.relu(torch.randn(shape, device=dev, generator=generator)).to(dtype)

    # the ragged shapes draw from their own generator, so the main shapes'
    # inputs stay those of the runs before they were added
    gen_ragged = torch.Generator(device=dev).manual_seed(2)
    gen_pooled_ragged = torch.Generator(device=dev).manual_seed(3)
    gen_bwd_ragged = torch.Generator(device=dev).manual_seed(4)
    gen_pooled_large_s = torch.Generator(device=dev).manual_seed(5)
    gen_family = torch.Generator(device=dev).manual_seed(6)
    gen_f3_bwd = torch.Generator(device=dev).manual_seed(15)
    gen_stage = torch.Generator(device=dev).manual_seed(22)
    gen_b16 = torch.Generator(device=dev).manual_seed(44)

    def bwd_row(f, dg, shape, dtype, dname, es):
        n, h, w, c = shape
        hw = h * w
        err, rel, rms, ok = check(kg.gram_bwd(f, dg), kg.gram_bwd_plain(f, dg), dtype)
        route, row_tile, _, k_splits, _ = kg.gram_bwd_plan_for(f, dg, torch.empty_like(f))
        bound, by = _bound(2.0 * n * hw * c * c + n * c * c,
                           (2 * n * hw * c + n * c * c) * es, dtype, peaks)
        sym, out = torch.empty_like(dg), torch.empty_like(f)

        def two_calls():  # the yardstick: symmetrise dG, then one batched product
            torch.add(dg, dg.transpose(1, 2), out=sym)
            torch.baddbmm(out, f, sym, beta=0, alpha=1.0 / hw)

        # whether the k-split merge gives the same bits on a second call
        repeatable = torch.equal(kg.gram_bwd(f, dg), kg.gram_bwd(f, dg))
        return dict(
            shape=[n, h, w, c], dtype=dname, route=route, row_tile=row_tile, k_splits=k_splits,
            repeatable=repeatable,
            max_abs_err=err, rel_err=rel, rms_err=rms, tol=TOL[dname],
            ok=ok, ms=_time_ms(lambda: kg.gram_bwd(f, dg)),
            plain_ms=_time_ms(lambda: kg.gram_bwd_plain(f, dg)),
            library_ms=None,  # no single PyTorch call symmetrises dG inside a product
            two_call_ms=_time_ms(two_calls), bound_ms=bound, bound_by=by)

    from heuristique_style_transfer_code_tpu_torch.ops.pooling import adaptive_pool_matrix

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        dname = str(dtype).split(".")[1]
        for (n, h, w, c) in (GRAM_SHAPES + STAGE_GRAM_SHAPES + RAGGED_GRAM_SHAPES + F3_GRAM_SHAPES
                             + B16_GRAM_SHAPES):
            hw = h * w
            stage = (n, h, w, c) in STAGE_GRAM_SHAPES
            b16 = (n, h, w, c) in B16_GRAM_SHAPES
            main = (n, h, w, c) in GRAM_SHAPES or stage or b16
            g_in = (gen if (n, h, w, c) in GRAM_SHAPES else gen_stage if stage
                    else gen_b16 if b16
                    else gen_family if (n, h, w, c) in F3_GRAM_SHAPES else gen_ragged)
            f = features((n, hw, c), dtype, g_in)
            # forward
            err, rel, rms, ok = check(kg.gram_fwd(f), kg.gram_fwd_plain(f), dtype)
            out = torch.empty((n, c, c), device=dev, dtype=dtype)
            ft = f.transpose(1, 2)
            route, _, splits, _ = kg.gram_fwd_plan_for(f)
            # the work that is needed: G's C(C+1)/2 distinct entries
            bound, by = _bound(1.0 * n * hw * c * (c + 1), (n * hw * c + n * c * c) * es,
                               dtype, peaks)
            rows["gram_fwd"].append(dict(
                shape=[n, h, w, c], dtype=dname, route=route, splits=splits, max_abs_err=err,
                rel_err=rel, rms_err=rms, tol=TOL[dname],
                ok=ok, ms=_time_ms(lambda: kg.gram_fwd(f)),
                plain_ms=_time_ms(lambda: kg.gram_fwd_plain(f)),
                library_ms=_time_ms(lambda: torch.baddbmm(out, ft, f, beta=0, alpha=1.0 / hw)),
                bound_ms=bound, bound_by=by))
            if (n, h, w, c) in F3_BWD_SHAPES:  # the family-3 style loop's Gram backward
                dg = torch.randn((n, c, c), device=dev, generator=gen_f3_bwd).to(dtype)
                rows["gram_bwd"].append(bwd_row(f, dg, (n, h, w, c), dtype, dname, es))
                del dg
            if not main:
                del f, out, ft
                continue
            # the style loss's cotangent 2(G - target)/C² is signed
            dg = torch.randn((n, c, c), device=dev, generator=g_in).to(dtype)
            rows["gram_bwd"].append(bwd_row(f, dg, (n, h, w, c), dtype, dname, es))
            del f, dg, out, ft
        for (n, h, w, c) in RAGGED_BWD_SHAPES:
            f = features((n, h * w, c), dtype, gen_bwd_ragged)
            dg = torch.randn((n, c, c), device=dev, generator=gen_bwd_ragged).to(dtype)
            rows["gram_bwd"].append(bwd_row(f, dg, (n, h, w, c), dtype, dname, es))
            del f, dg
        pooled_gens = {"main": gen, "ragged": gen_pooled_ragged, "large_s": gen_pooled_large_s,
                       "camera": gen_family}
        pooled_cases = ([(shape, POOL_S, "main") for shape in POOLED_SHAPES]
                        + [(shape, s, "ragged") for shape, s in RAGGED_POOLED]
                        + [(shape, s, "large_s") for shape, s in LARGE_S_POOLED]
                        + [(shape, s, "camera") for shape, s in F2_CAMERA_POOLED])
        for (n, h, w, c), s, kind in pooled_cases:
            hw = h * w
            f = features((n, hw, c), dtype, pooled_gens[kind])
            err, rel, rms, ok = check(kg.pooled_gram_fwd(f, s),
                                      kg.pooled_gram_fwd_plain(f, s), dtype)
            route = kg.pooled_gram_route_for(f, s)
            if route == "project":  # the splits of gram_fwd on the f32 projection
                splits = kg._gram_fwd_plan(n, hw, s, kg._sm_count(dev), torch.float32)[2]
            else:
                splits, _ = kg._pooled_gram_plan(n, hw, kg._sm_count(dev))
            # one read of F, one write of G; an add per element, the bin
            # weights and the S(S+1)/2 distinct products per row
            bound, by = _bound(1.0 * n * hw * (c + s + s * (s + 1)),
                               n * hw * c * es + n * s * s * es, dtype, peaks)
            pl = adaptive_pool_matrix(c, s, dev).to(dtype)
            rows["pooled_gram_fwd"].append(dict(
                shape=[n, h, w, c], s=s, dtype=dname, route=route, splits=splits,
                max_abs_err=err,
                rel_err=rel, rms_err=rms, tol=TOL[dname], ok=ok,
                ms=_time_ms(lambda: kg.pooled_gram_fwd(f, s)),
                plain_ms=_time_ms(lambda: kg.pooled_gram_fwd_plain(f, s)),
                # one call, the same contraction without the 1/HW scale of S*S outputs
                library_ms=_time_ms(lambda: torch.einsum("nkc,oc,nkd,pd->nop", f, pl, f, pl)),
                bound_ms=bound, bound_by=by))
            del f
    for name, rs in rows.items():
        for r in rs:
            route = f" S={r['s']}" if "s" in r else ""
            route += f" route={r['route']}" if "route" in r else ""
            route += f" splits={r['splits']}" if "splits" in r else ""
            route += (f" row_tile={r['row_tile']} k_splits={r['k_splits']} "
                      f"repeatable={r['repeatable']}" if "k_splits" in r else "")
            two = f" two_call_ms={r['two_call_ms']:.4f}" if "two_call_ms" in r else ""
            print(f"[kernels] {name} {r['dtype']} {tuple(r['shape'])}{route}: max_abs_err={r['max_abs_err']:.3e} "
                  f"rel={r['rel_err']:.3e} rms={r['rms_err']:.3e} (tol {r['tol']}) ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']}{two} bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    bad = [(name, r["dtype"], r["shape"]) for name, rs in rows.items() for r in rs if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return rows


def _cluster_candidates(kin, x) -> list:
    """Every configuration ``_plan`` examined for x, with the clusters the
    card holds at once (cudaOccupancyMaxActiveClusters), in its order."""
    seen = []

    def active(plan):
        n = kin._occupancy(x.device.index or 0, x.shape[1], x.shape[2], x.element_size(), plan)
        seen.append(dict(k=plan.k, resident_rows=plan.res_rows, ring_slots=plan.slots,
                         smem=plan.smem, clusters=n))
        return n

    b, hw, c = x.shape
    kin._plan(b, hw, c, x.element_size(), kin._aligned(x), active)
    return seen


def _run_plan(kin, x, scale, bias, relu, plan):
    """instance_norm_fwd's kernel on a given plan; counts no launch."""
    import torch

    y = torch.empty_like(x)
    kin._launch(kin.LIBRARY.load(), x, scale, bias, y, plan, kin.EPS, relu)
    return y


def _forced_in_checks(kin) -> list:
    """The cluster route forced onto ragged shapes (C = 48, an odd HW, a
    prime HW that does not divide into the blocks, streamed rows that do
    not divide into stages), and a misaligned bf16 input, which the plan
    sends to the split route's scalar loads; each against the plain
    version at TOL_IN. Not timed; outside the main path's launch counts."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    out = []
    for (b, h, w, c) in [(3, 37, 29, 48), (2, 1, 1009, 16)]:
        hw = h * w
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((b, hw, c), device=dev, generator=gen) * 2 + 0.5).to(dtype)
            scale = torch.randn((b, c), device=dev, generator=gen)
            bias = torch.randn((b, c), device=dev, generator=gen)
            want = kin.instance_norm_fwd_plain(x, scale, bias, relu=True).double()
            plans = []
            for k in (3, 16):  # every row resident
                res = -(-hw // k)
                plans.append(kin.Plan("cluster", k, res, max(1, -(-res // 16)), 0, 0))
            for k, stage in ((2, 7), (5, 13)):  # a third resident, the rest streamed
                res = -(-hw // k) // 3
                plans.append(kin.Plan("cluster", k, res, max(1, -(-res // 16)), stage, 2))
            for plan in plans:
                got = _run_plan(kin, x, scale, bias, True, plan).double()
                torch.cuda.synchronize()
                diff = got - want
                rel = (diff.abs().max() / want.abs().max()).item()
                rms = (diff.norm() / want.norm()).item()
                tol_max, tol_rms = TOL_IN[str(dtype).split(".")[1]]
                out.append(dict(shape=[b, h, w, c], dtype=str(dtype).split(".")[1],
                                plan=plan._asdict(), rel_err=rel, rms_err=rms,
                                ok=rel <= tol_max and rms <= tol_rms))
    flat = torch.randn((1 + 4 * 99 * 24,), device=dev, generator=gen).to(torch.bfloat16)
    x = flat[1:].view(4, 99, 24)  # 2 bytes past a 16-byte boundary
    scale = torch.randn((4, 24), device=dev, generator=gen)
    bias = torch.randn((4, 24), device=dev, generator=gen)
    plan = kin.instance_norm_plan_for(x)
    got = kin.instance_norm_fwd(x, scale, bias, relu=True).double()
    want = kin.instance_norm_fwd_plain(x, scale, bias, relu=True).double()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    rms = ((got - want).norm() / want.norm()).item()
    out.append(dict(shape=[4, 1, 99, 24], dtype="bfloat16", misaligned=True, plan=plan._asdict(),
                    rel_err=rel, rms_err=rms,
                    ok=plan.route == "split" and rel <= TOL_IN["bfloat16"][0]
                    and rms <= TOL_IN["bfloat16"][1]))
    for r in out:
        p = r["plan"]
        print(f"[kernels] instance_norm_fwd forced {r['dtype']} {tuple(r['shape'])}"
              f"{' misaligned' if r.get('misaligned') else ''} route={p['route']} k={p['k']} "
              f"resident_rows={p['res_rows']} stage_rows={p['stage_rows']}: "
              f"rel={r['rel_err']:.3e} rms={r['rms_err']:.3e} ok={r['ok']}")
    bad = [(r["dtype"], r["shape"], r["plan"]) for r in out if not r["ok"]]
    if bad:
        raise RuntimeError(f"instance_norm_fwd disagrees with its plain version: {bad}")
    return out


def phase_in_kernels(kin, peaks):
    """instance_norm_fwd against its plain version; returns one row per
    case, and the forced-route checks. Inputs are signed, like conv outputs
    (randn * 2 + 0.5 plus per-channel offsets), with per-image scale and
    bias rows that differ. The mean-1e3 cases are held against the plain
    version run in float64 on the same values: in f32 the plain version's
    own mean rounds by about 3e-5 at 1e3, which is 1e-5 of the output, the
    tolerance itself. Each row names the route the plan took, its cluster
    size k, the share of x that stays in shared memory, the bytes of x read
    a second time and how many such clusters the card holds at once; rows
    on the cluster route also time the split route on the same inputs
    (``split_ms``: PR 2's three launches)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # the ladder's smaller batches and a net shape at mean 1e3 draw from
    # their own generator, so the earlier cases' inputs stay as they were
    gen_more = torch.Generator(device=dev).manual_seed(8)
    cases = [(shape, dtype, relu, "signed", gen) for shape in IN_SHAPES
             for dtype in (torch.float32, torch.bfloat16) for relu in (False, True)]
    cases += [((3, 37, 29, 48), dtype, True, "signed", gen)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [((2, 13, 11, 5), dtype, True, "signed", gen)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [((1, 512, 512, 32), torch.bfloat16, True, "signed", gen),
              ((2, 224, 224, 32), torch.float32, False, "mean 1e3", gen)]
    cases += [(shape, dtype, True, "signed", gen_more) for shape in LADDER_IN_SHAPES
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [((8, 56, 56, 128), torch.float32, False, "mean 1e3", gen_more)]
    gen_family = torch.Generator(device=dev).manual_seed(12)
    cases += [(shape, dtype, True, "unit affine", gen_family) for shape in F3_IN_SHAPES
              for dtype in (torch.float32, torch.bfloat16)]
    gen_b16 = torch.Generator(device=dev).manual_seed(45)
    cases += [(shape, dtype, relu, "signed", gen_b16) for shape in B16_IN_SHAPES
              for dtype in (torch.float32, torch.bfloat16) for relu in (False, True)]
    gen_f3t = torch.Generator(device=dev).manual_seed(90)
    cases += [(shape, dtype, False, "unit affine", gen_f3t) for shape in F3T_IN_SHAPES
              for dtype in (torch.float32, torch.bfloat16)]
    rows = []
    for (b, h, w, c), dtype, relu, kind, g in cases:
        hw = h * w
        dname = str(dtype).split(".")[1]
        if kind == "mean 1e3":  # std 1 around 1e3: a one-pass variance fails here
            xf = torch.randn((b, hw, c), device=dev, generator=g) + 1e3
        else:
            xf = (torch.randn((b, hw, c), device=dev, generator=g) * 2 + 0.5
                  + torch.randn((c,), device=dev, generator=g))
        x = xf.to(dtype)
        if kind == "unit affine":  # the family-3 discriminator's non-affine norm
            scale = torch.ones((b, c), device=dev)
            bias = torch.zeros((b, c), device=dev)
        else:
            scale = torch.randn((b, c), device=dev, generator=g)
            bias = torch.randn((b, c), device=dev, generator=g)
        got = kin.instance_norm_fwd(x, scale, bias, relu=relu)
        torch.cuda.synchronize()
        ref = x.double() if kind == "mean 1e3" else x
        want = kin.instance_norm_fwd_plain(ref, scale, bias, relu=relu).double()
        diff = got.double() - want
        err = diff.abs().max().item()
        rel = err / want.abs().max().item()
        rms = (diff.norm() / want.norm()).item()
        tol_max, tol_rms = TOL_IN[dname]
        ok = bool(torch.isfinite(got.float()).all()) and rel <= tol_max and rms <= tol_rms
        extra = {}
        if kind == "mean 1e3":  # what the f32 plain version itself is off by here
            p32 = kin.instance_norm_fwd_plain(x, scale, bias, relu=relu).double()
            extra["plain_f32_rel_err"] = ((p32 - want).abs().max() / want.abs().max()).item()
        plan = kin.instance_norm_plan_for(x)
        share, reread = kin.plan_traffic(plan, b, hw, c, x.element_size())
        if plan.route == "cluster":
            extra["split_ms"] = _time_ms(
                lambda: _run_plan(kin, x, scale, bias, relu, kin.SPLIT))
            if (b, h, w, c) in IN_SHAPES and relu:
                extra["candidates"] = _cluster_candidates(kin, x)
        # 1 read of x, 1 write of y, the (B, C) rows; about 7 f32 operations
        # per element (shift, sums, deviation square, apply), on CUDA cores
        es = x.element_size()
        bound, by = _bound(7.0 * b * hw * c, 2 * b * hw * c * es + 2 * b * c * 4,
                           torch.float32, peaks)
        x4 = x.view(b, h, w, c).permute(0, 3, 1, 2)  # channels_last NCHW view
        s0, b0 = scale[0], bias[0]
        rows.append(dict(
            shape=[b, h, w, c], dtype=dname, relu=relu, input=kind, max_abs_err=err,
            rel_err=rel, rms_err=rms, tol=[tol_max, tol_rms], ok=ok,
            route=plan.route, k=plan.k, resident_share=share, reread_bytes=reread,
            clusters=plan.clusters, plan=plan._asdict(),
            ms=_time_ms(lambda: kin.instance_norm_fwd(x, scale, bias, relu=relu)),
            plain_ms=_time_ms(lambda: kin.instance_norm_fwd_plain(x, scale, bias, relu=relu)),
            # one library call: a single (C,) affine, no ReLU
            library_ms=_time_ms(lambda: F.instance_norm(x4, weight=s0, bias=b0, eps=kin.EPS)),
            bound_ms=bound, bound_by=by, **extra))
        del x, xf, got, want, diff
    for r in rows:
        print(f"[kernels] instance_norm_fwd {r['dtype']} {tuple(r['shape'])} relu={r['relu']} "
              f"{r['input']}: route={r['route']} k={r['k']} resident={r['resident_share']:.3f} "
              f"reread_bytes={r['reread_bytes']} clusters={r['clusters']} "
              f"max_abs_err={r['max_abs_err']:.3e} rel={r['rel_err']:.3e} "
              f"rms={r['rms_err']:.3e} (tol {r['tol']}) ms={r['ms']:.4f} "
              + (f"split_ms={r['split_ms']:.4f} " if "split_ms" in r else "")
              + f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
              + (f" plain_f32_rel_err={r['plain_f32_rel_err']:.3e}" if "plain_f32_rel_err" in r
                 else ""))
        if "candidates" in r:
            print(f"[kernels]   cluster configurations the plan examined (k, resident rows, "
                  f"ring slots, smem, clusters at once): "
                  + ", ".join(f"({q['k']}, {q['resident_rows']}, {q['ring_slots']}, {q['smem']}, "
                              f"{q['clusters']})" for q in r["candidates"]))
    bad = [(r["dtype"], r["shape"], r["relu"], r["input"]) for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"instance_norm_fwd disagrees with its plain version: {bad}")
    return rows, _forced_in_checks(kin)


def _batches(n_images: int, batch: int, seed: int):
    """In-memory batches with HostLoader's contract: staged 256² uint8."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for i in range(0, n_images, batch):
        out.append({
            "image": rng.randint(0, 256, (batch, 256, 256, 3)).astype(np.uint8),
            "label": rng.randint(0, 4, (batch,)).astype(np.int32),
            "indices": np.arange(i, i + batch),
            "n_valid": batch,
        })
    return out


def phase_classification(kernels, tmp: str, timings: dict):
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import (
        load_gram_attention,
        run_classification,
    )
    from heuristique_style_transfer_code_tpu_torch.core.device import resolve_device
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )

    dev = resolve_device(DEVICE)
    truncate, s, classes, batch = 8, POOL_S, 4, 8
    seeded = gram_attention_init(torch.Generator().manual_seed(0), truncate, classes, s,
                                 device="cpu")
    ckpt = os.path.join(tmp, "family2.npz")
    save_pytree_npz(to_jax_tree(seeded), ckpt)
    model = load_gram_attention(ckpt, truncate, classes, s, dev)
    batches = _batches(N_IMAGES, batch, seed=1)
    out_dir = os.path.join(tmp, "classification")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_classification(model, batches, out_dir, truncate=truncate,
                                 gram_matrix_size=s, num_classes=classes)
    torch.cuda.synchronize()
    timings["classification_s"] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"[classification] {json.dumps(results)} launches={launches} "
          f"seconds={timings['classification_s']:.3f}")
    _require(os.path.exists(os.path.join(out_dir, "classification_results.json")),
             "classification_results.json written")
    _require(launches["pooled_gram_fwd"] == 4 * len(batches),
             f"pooled_gram_fwd launched 4 times per batch: {launches}")
    _require(all(np.isfinite(v) for v in results.values()), f"finite metrics: {results}")

    # reference on a small input: the same weights on the CPU (plain Grams)
    with torch.inference_mode():
        x = eval_preprocess(torch.from_numpy(batches[0]["image"][:2]))
        emb_c, logits_c = gram_attention_apply(model, x.to(dev), truncate, s, classes)
        emb_r, logits_r = gram_attention_apply(seeded, x, truncate, s, classes)
    err = (logits_c.cpu() - logits_r).abs().max().item() / logits_r.abs().max().item()
    err_e = (emb_c.cpu() - emb_r).abs().max().item() / emb_r.abs().max().item()
    print(f"[classification] card vs CPU reference (2 images, f32): logits rel err {err:.3e}, "
          f"embeddings rel err {err_e:.3e} (tol 1e-3)")
    _require(logits_c.shape == (2, classes) and bool(torch.isfinite(logits_c).all()),
             f"finite logits of shape (2, {classes})")
    _require(err <= 1e-3 and err_e <= 1e-3, f"card agrees with the CPU: {err}, {err_e}")
    return model, seeded, launches


def phase_style_transfer(kernels, model, seeded, tmp: str, timings: dict):
    import torch

    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_gram_fn_gram_attention,
        make_style_transfer_optimizer,
        style_transfer_gram_attention,
    )

    layers, batch, iters = 5, 4, STYLE_ITERS
    batches = _batches(N_IMAGES, batch, seed=2)
    out_dir = os.path.join(tmp, "style")
    history = []

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saved = style_transfer_gram_attention(
        model, batches, out_dir, layers=layers, threshold=0.0, num_iterations=iters,
        truncate_layer=8, generator=torch.Generator().manual_seed(0), history=history,
        log_fn=lambda msg: None,
    )
    torch.cuda.synchronize()
    timings["style_transfer_s"] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    first = [h[0].mean().item() for h in history]
    last = [h[-1].mean().item() for h in history]
    print(f"[style_transfer] {len(saved)} PNGs, iterations per batch {[len(h) for h in history]}, "
          f"mean loss it1 {first} -> it{iters} {last}, launches={launches}, "
          f"seconds={timings['style_transfer_s']:.3f}")
    _require(all(len(h) == iters for h in history), f"{iters} iterations per batch")
    _require(launches["gram_fwd"] >= iters and launches["gram_bwd"] >= iters,
             f"gram_fwd and gram_bwd launched at least {iters} times: {launches}")
    _require(all(b < a for a, b in zip(first, last)), f"mean loss fell: {first} -> {last}")
    _require(len(saved) == N_IMAGES and all(os.path.exists(p) for p in saved),
             f"{N_IMAGES} PNGs written")

    # reference on a small input: 3 iterations at 64 px, card vs CPU
    noise0 = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    traj = {}
    for name, m, dev in (("card", model, DEVICE), ("cpu", seeded, "cpu")):
        gram_fn = make_gram_fn_gram_attention(m, 8, layers=layers)
        with torch.no_grad():
            targets = gram_fn(noise0.to(dev) * 0.5 + 0.1)
        run = make_style_transfer_optimizer(gram_fn, 0.01, 3, 0.0)
        h = []
        run(noise0.to(dev), targets, h)
        traj[name] = torch.stack([p.cpu() for p in h])
    err = ((traj["card"] - traj["cpu"]).abs() / traj["cpu"].abs()).max().item()
    print(f"[style_transfer] card vs CPU reference (2 images 64 px, 3 iterations): "
          f"loss trajectory rel err {err:.3e} (tol 1e-3)")
    _require(bool(torch.isfinite(traj["card"]).all()) and err <= 1e-3,
             f"card loss trajectory agrees with the CPU: {err}")
    return launches


def _serve(argv):
    """The port's serve_style as its CLI builds it: ``start(args)``, then
    the HTTP server on a thread; returns (server, service, base url)."""
    from heuristique_style_transfer_code_tpu_torch.cli.serve_style import build_parser, start

    srv, service = start(build_parser().parse_args(argv))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, service, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, service) -> None:
    srv.shutdown()
    srv.server_close()
    service.stop(drain=True)


def _post_raw(url: str, img):
    req = urllib.request.Request(url + "/style", data=img.tobytes(), method="POST",
                                 headers={"X-Raw-Shape": ",".join(map(str, img.shape))})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read(), dict(r.headers)


def _get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, r.read().decode()


def _u8_gap(a, b) -> int:
    import numpy as np

    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16)).max())


def phase_fast_style(kernels, tmp: str, timings: dict) -> dict:
    """serve_style --net at full width: 16 concurrent raw POSTs."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
        save_model_and_hyperparameters,
    )
    from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import (
        count_params,
        transformer_net_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.fast_style import make_stylize_fn
    from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

    net_cpu = transformer_net_init(torch.Generator().manual_seed(0), width=32, n_res=5,
                                   device="cpu")
    net_path = save_model_and_hyperparameters(
        to_jax_tree(net_cpu), {"crop": 224, "style_names": ["seeded"]}, tmp, "style_net")
    t0 = time.perf_counter()
    srv, service, url = _serve(["--net", net_path, "--batch_size", "4,8", "--port", "0",
                                "--device", DEVICE])
    timings["fast_style_start_s"] = time.perf_counter() - t0
    images = np.random.RandomState(4).randint(0, 256, (N_REQUESTS, 224, 224, 3)).astype(np.uint8)
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(REQUEST_THREADS) as pool:
            answers = list(pool.map(lambda im: _post_raw(url, im), images))
        timings["fast_style_16_requests_s"] = time.perf_counter() - t0
        launches = kernels.launch_counts()
        stats = json.loads(_get(url, "/stats")[1])
        health = _get(url, "/healthz")
    finally:
        _stop(srv, service)
    print(f"[fast_style] {count_params(net_cpu)} parameters; {N_REQUESTS} requests in "
          f"{timings['fast_style_16_requests_s']:.3f} s (start {timings['fast_style_start_s']:.2f} s); "
          f"stats {json.dumps(stats)}; launches={launches}")
    outs = [decode_png(body) for _, body, _ in answers]
    _require(all(st == 200 and h.get("X-Iterations") == "1" for st, _, h in answers),
             "every answer is 200 with X-Iterations: 1")
    _require(all(o.shape == (224, 224, 3) for o in outs), "every answer is a 224x224 RGB PNG")
    _require(stats["jobs"] == N_REQUESTS, f"/stats counts {N_REQUESTS} jobs: {stats}")
    _require(health[0] == 200, f"/healthz answers 200: {health}")
    _require(launches["instance_norm_fwd"] == NORMS_PER_FORWARD * stats["batches"],
             f"instance_norm_fwd launched {NORMS_PER_FORWARD} times per batch "
             f"({stats['batches']} batches): {launches}")
    ref = make_stylize_fn(net_cpu, crop=224)(images[:1]).numpy()[0]
    gap = _u8_gap(outs[0], ref)
    print(f"[fast_style] served answer vs the same net on the CPU: max gap {gap} uint8 steps "
          f"(tol 1)")
    _require(gap <= 1, f"served answer within 1 uint8 step of the CPU: {gap}")
    return launches


def phase_conditional(kernels) -> None:
    """A 3-style conditional net with blended per-image rows, card vs CPU;
    then bf16 against f32 on the card."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import (
        InstanceNorm,
        transformer_net_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.fast_style import (
        make_net_job_fn,
        make_stylize_fn,
    )

    gen = torch.Generator().manual_seed(5)
    net_cpu = transformer_net_init(gen, width=32, n_res=5, n_styles=3, device="cpu")
    with torch.no_grad():  # styles that differ: init gives every style ones and zeros
        for m in net_cpu.modules():
            if isinstance(m, InstanceNorm):
                m.weight.add_(0.3 * torch.randn(m.weight.shape, generator=gen))
                m.bias.add_(0.3 * torch.randn(m.bias.shape, generator=gen))
    net = transformer_net_init(None, width=32, n_res=5, n_styles=3, device=DEVICE)
    net.load_state_dict(net_cpu.state_dict())
    images = np.random.RandomState(6).randint(0, 256, (4, 224, 224, 3)).astype(np.uint8)
    w = np.array([[1, 0, 0], [0.2, 0.5, 0.3], [0, 0.4, 0.6], [1 / 3, 1 / 3, 1 / 3]], np.float32)
    ids = np.arange(4, dtype=np.int32)
    kernels.reset_launch_counts()
    got = make_net_job_fn(net, crop=224)(images, w, ids)[0].cpu().numpy()
    launches = kernels.launch_counts()["instance_norm_fwd"]
    want = make_net_job_fn(net_cpu, crop=224)(images, w, ids)[0].numpy()
    gap = _u8_gap(got, want)
    f32 = make_stylize_fn(net, crop=224, style_weights=w)(images).cpu().numpy()
    bf16 = make_stylize_fn(net, crop=224, style_weights=w,
                           compute_dtype=torch.bfloat16)(images).cpu().numpy()
    gap16 = np.abs(f32.astype(np.float32) - bf16.astype(np.float32)).max() / 255.0
    print(f"[conditional] 3 styles, blended rows: card vs CPU max gap {gap} uint8 steps (tol 1), "
          f"instance_norm_fwd launches {launches}; bf16 vs f32 max {gap16:.4f} in [0, 1] "
          f"(tol 0.05)")
    _require(launches == NORMS_PER_FORWARD, f"{NORMS_PER_FORWARD} norms per forward: {launches}")
    _require(gap <= 1, f"conditional net on the card within 1 step of the CPU: {gap}")
    _require(gap16 <= 0.05, f"bf16 within 0.05 of f32: {gap16}")


def phase_texture_serve(kernels, tmp: str) -> dict:
    """serve_style texture mode on the classification phase's model."""
    import numpy as np
    import torch

    ckpt = os.path.join(tmp, "family2.npz")  # written by phase_classification
    cfg = os.path.join(tmp, "family2.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 8, "truncate_layer": 8, "gram_matrix_size": POOL_S}, f)
    srv, service, url = _serve(["--config_path", cfg, "--model_path", ckpt, "--layers", "5",
                                "--num_iterations", "5", "--threshold", "0",
                                "--batch_size", "2", "--port", "0", "--device", DEVICE])
    images = np.random.RandomState(7).randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        with ThreadPoolExecutor(2) as pool:
            answers = list(pool.map(lambda im: _post_raw(url, im), images))
        launches = kernels.launch_counts()
        stats = json.loads(_get(url, "/stats")[1])
    finally:
        _stop(srv, service)
    iters = [h.get("X-Iterations") for _, _, h in answers]
    print(f"[texture_serve] X-Iterations {iters}, X-Final-Loss "
          f"{[h.get('X-Final-Loss') for _, _, h in answers]}, stats {json.dumps(stats)}, "
          f"launches={launches}")
    _require(all(st == 200 for st, _, _ in answers) and iters == ["5", "5"],
             f"both answers carry X-Iterations: 5: {iters}")
    _require(launches["gram_fwd"] > 0 and launches["gram_bwd"] > 0,
             f"gram_fwd and gram_bwd launched: {launches}")
    return launches


def _family1(tmp: str):
    """The family-1 model at full width (truncate 8, dim 256, 4 classes),
    seeded on the CPU, written as npz and read back onto the card by the
    CLI's loader; returns (card model, CPU model, forward)."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli._common import load_truncated_resnet50
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply,
        truncated_resnet50_init,
    )

    seeded = truncated_resnet50_init(torch.Generator().manual_seed(8), F1_TRUNCATE, F1_CLASSES,
                                     F1_DIM, device="cpu")
    ckpt = os.path.join(tmp, "family1.npz")
    save_pytree_npz(to_jax_tree(seeded), ckpt)
    model = load_truncated_resnet50(ckpt, F1_TRUNCATE, torch.device(DEVICE))

    def forward(m, images):
        return combined_apply(m.moco, m.classifier, images, F1_TRUNCATE)

    return model, seeded, forward


def _probs_gap(card, cpu) -> float:
    import numpy as np

    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    return float(np.abs(card - cpu).max() / np.abs(cpu).max())


def phase_family1_classification(kernels, family1, tmp: str, timings: dict) -> None:
    """Family 1's ``--mode classification`` through its device loop and
    text artifacts (``evaluate_classification``, ``write_metrics_text``,
    ``write_auc_and_times``) at b32, f32 and bf16, threshold 0."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli._common import cast_forward
    from heuristique_style_transfer_code_tpu_torch.tasks.classification import (
        evaluate_classification,
        write_auc_and_times,
        write_metrics_text,
    )

    model, seeded, forward = family1
    batches = _batches(F1_IMAGES, F1_BATCH, seed=8)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        fwd = cast_forward(forward, None if dtype == torch.float32 else dtype)
        out_dir = os.path.join(tmp, f"family1_{name}")

        def run(m, bs, measure):
            return evaluate_classification(fwd, m, bs, F1_CLASSES, prob_threshold=0.0,
                                           measure_time=measure)

        run(model, batches[:1], False)  # warm-up: cuDNN plans, allocator
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(model, batches, True)
        timings[f"family1_classification_{name}_s"] = time.perf_counter() - t0
        launches = kernels.launch_counts()
        write_metrics_text(res, out_dir, log_fn=lambda msg: None)
        write_auc_and_times(res, out_dir, compute_auc=False, measure_time=True,
                            log_fn=lambda msg: None)
        times = np.asarray(res["timer"].times)
        ips = F1_BATCH / float(np.median(times))
        card1 = run(model, batches[:1], False)
        cpu1 = run(seeded, batches[:1], False)
        gap = _probs_gap(card1["probs"], cpu1["probs"])
        loss_gap = abs(card1["loss"] - cpu1["loss"]) / abs(cpu1["loss"])
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        print(f"[family1_classification] {name} b{F1_BATCH}: {F1_BATCH * len(batches)} images, "
              f"{ips:.1f} images/s (median of {len(times)} batch spans "
              f"{[round(float(t) * 1e3, 3) for t in times]} ms), accuracy {res['accuracy']}, "
              f"loss {res['loss']:.6f}, confusion matrix {res['confusion_matrix'].tolist()}; "
              f"card vs CPU on batch 0: probabilities {gap:.3e} of max|p|, loss {loss_gap:.3e} "
              f"(tol {tol}); hand-written launches {launches}")
        timings[f"family1_classification_{name}_images_per_s"] = ips
        _require(os.path.exists(os.path.join(out_dir, "metrics.txt"))
                 and os.path.exists(os.path.join(out_dir, "times_test.json")),
                 "metrics.txt and times_test.json written")
        _require(len(times) == len(batches), f"one span a batch: {len(times)}")
        _require(int(res["confusion_matrix"].sum()) == F1_BATCH * len(batches),
                 "threshold 0 counts every image in the confusion matrix")
        _require(bool(np.isfinite(res["probs"]).all()) and np.isfinite(res["loss"]),
                 "finite probabilities and loss")
        _require(gap <= tol and loss_gap <= tol, f"card agrees with the CPU: {gap}, {loss_gap}")
        _require(not any(launches.values()), f"family 1 launches no hand-written kernel: "
                                              f"{launches}")


def phase_family1_inference(kernels, family1, tmp: str) -> None:
    """``run_inference`` over 40 PNGs written here, with ``measure_time``."""
    import numpy as np
    import torch
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch.tasks.inference import run_inference

    model, seeded, forward = family1
    src = os.path.join(tmp, "inference_input")
    rng = np.random.RandomState(9)
    for i in range(F1_INFER_IMAGES):
        d = os.path.join(src, f"part{i % 3}")
        os.makedirs(d, exist_ok=True)
        h, w = (300, 400) if i % 2 else (256, 256)
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(d, f"img_{i:03d}.png"))
    classes = ["fog", "rain", "snow", "sun"]
    kernels.reset_launch_counts()
    got = run_inference(forward, model, src, classes, os.path.join(tmp, "inference_card"),
                        batch_size=F1_BATCH, measure_time=True)
    launches = kernels.launch_counts()
    want = run_inference(forward, seeded, src, classes, os.path.join(tmp, "inference_cpu"),
                         batch_size=F1_BATCH)
    with open(os.path.join(tmp, "inference_card", "inference_predictions.json")) as f:
        on_disk = json.load(f)
    p_card = [list(r["class_probabilities"].values()) for r in got["predictions"]]
    p_cpu = [list(r["class_probabilities"].values()) for r in want["predictions"]]
    gap = _probs_gap(p_card, p_cpu)
    print(f"[family1_inference] {got['num_images']} images, timing {json.dumps(got['timing'])}, "
          f"card vs CPU probabilities {gap:.3e} of max|p| (tol 1e-4); hand-written launches "
          f"{launches}")
    _require(on_disk == got and list(got) == ["num_images", "classes", "predictions", "timing"],
             f"inference_predictions.json keys: {list(on_disk)}")
    _require(got["num_images"] == F1_INFER_IMAGES and got["classes"] == classes,
             f"{F1_INFER_IMAGES} images and the classes")
    _require(all(list(r) == ["image_path", "predicted_class_index", "predicted_class",
                             "predicted_probability", "class_probabilities"]
                 for r in got["predictions"]), "prediction records' keys")
    _require([r["image_path"] for r in got["predictions"]]
             == [r["image_path"] for r in want["predictions"]], "the same images in order")
    _require(gap <= 1e-4, f"card agrees with the CPU: {gap}")
    _require(not any(launches.values()), f"family 1 launches no hand-written kernel: {launches}")


def _camera_frames(seed: int):
    """CAMERA_FRAMES + 1 consecutive frames of each kind: 224² RGB (the
    host-downscaled ship), 480x640 RGB, and planar I420 (336, 224), a
    base plus a small drift a frame. Any planar uint8 buffer of that
    shape is a valid I420 frame, so no OpenCV is needed."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = {}
    for key, shape in (("rgb224", (224, 224, 3)), ("rgb480", (480, 640, 3)),
                       ("yuv420", (336, 224))):
        base = rng.randint(0, 256, shape).astype(np.int16)
        drift = rng.randint(-2, 3, (CAMERA_FRAMES + 1,) + shape).cumsum(axis=0)
        out[key] = np.clip(base + drift, 0, 255).astype(np.uint8)
    return out


def phase_camera(kernels, family1, timings: dict) -> None:
    """The camera infer functions at b1, f32 and bf16: host-downscaled
    RGB, RGB resized on the card, I420, and the stateful I420 delta. One
    warm-up frame, then CAMERA_FRAMES frames, each timed from the ship to
    its probabilities on the host."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli._common import cast_forward
    from heuristique_style_transfer_code_tpu_torch.tasks import camera as cam

    model, seeded, forward = family1
    frames = _camera_frames(10)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        fwd = cast_forward(forward, None if dtype == torch.float32 else dtype)
        paths = {
            "rgb_host_downscale": (cam.make_camera_infer_fn(fwd, host_downscale=True), "rgb224"),
            "rgb_device_resize": (cam.make_camera_infer_fn(fwd, host_downscale=False), "rgb480"),
            "yuv420": (cam.make_camera_infer_fn_yuv(fwd, 224), "yuv420"),
        }
        probs = {}
        for path, (infer, key) in paths.items():
            seq = frames[key]
            infer(model, seq[0]).cpu()  # warm-up
            kernels.reset_launch_counts()
            out, times = [], []
            for f in seq[1:]:
                t0 = time.perf_counter()
                out.append(infer(model, f).cpu())
                times.append(time.perf_counter() - t0)
            launches = kernels.launch_counts()
            probs[path] = torch.stack(out).numpy()
            gap = _probs_gap(probs[path][0], infer(seeded, seq[1]).numpy())
            _camera_report(path, name, times, gap, launches, timings)
        # the stateful delta over the yuv420 path's frames: the same inputs
        delta1 = cam.make_camera_infer_fn_yuv_delta1(fwd, 224)
        seq = frames["yuv420"]
        prev = torch.zeros(seq[0].shape, dtype=torch.uint8, device=DEVICE)
        delta1(model, prev, prev)[0].cpu()  # warm-up, state-neutral
        prev_host = seq[0]
        prev = torch.as_tensor(seq[0]).to(DEVICE)
        kernels.reset_launch_counts()
        out, times = [], []
        for f in seq[1:]:
            t0 = time.perf_counter()
            p, prev = delta1(model, prev, f - prev_host)  # uint8 wraparound
            out.append(p.cpu())
            times.append(time.perf_counter() - t0)
            prev_host = f
        launches = kernels.launch_counts()
        got = torch.stack(out).numpy()
        same = float(np.abs(got - probs["yuv420"]).max())
        want, _ = delta1(seeded, torch.as_tensor(seq[0]), seq[1] - seq[0])
        gap = _probs_gap(got[0], want.numpy())
        _camera_report("yuv420_delta1", name, times, gap, launches, timings)
        print(f"[camera] {name} yuv420_delta1 vs yuv420 on the same {len(seq) - 1} frames: "
              f"max |dp| {same:.3e} (tol 1e-6); carried frame exact: "
              f"{bool(torch.equal(prev.cpu(), torch.as_tensor(seq[-1])))}")
        _require(same <= 1e-6, f"the delta path's probabilities are the yuv420 path's: {same}")
        _require(torch.equal(prev.cpu(), torch.as_tensor(seq[-1])), "the carried frame is exact")


def phase_camera_video(family1, tmp: str, timings: dict) -> None:
    """``--mode camera`` on a short MJPG file written here (OpenCV is on
    the card machine): the CLI on the card, then ``run_camera`` on the card
    and on the CPU, whose summaries must agree."""
    import cv2
    import numpy as np

    from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import (
        main as cli_main,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.camera import run_camera

    model, seeded, forward = family1
    video = os.path.join(tmp, "camera.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 30, (640, 480))
    for f in _camera_frames(11)["rgb480"][:VIDEO_FRAMES]:
        writer.write(f)
    writer.release()
    cfg = os.path.join(tmp, "family1.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": F1_BATCH, "truncate_layer": F1_TRUNCATE, "dim": F1_DIM}, f)
    out = os.path.join(tmp, "camera_cli")
    cli_main(["--config_path", cfg, "--model_path", os.path.join(tmp, "family1.npz"),
              "--mode", "camera", "--camera_index", video, "--measure_time",
              "--prob_threshold", "0", "--save_dir", out, "--device", DEVICE])
    with open(os.path.join(out, "times_camera.json")) as f:
        cli_times = json.load(f)
    common = dict(camera_index=video, display=False, prob_threshold=0.0,
                  log_fn=lambda msg: None)
    card = run_camera(forward, model, ["fog", "rain", "snow", "sun"], **common)
    cpu = run_camera(forward, seeded, ["fog", "rain", "snow", "sun"], **common)
    timings["camera_video"] = card
    print(f"[camera_video] CLI --mode camera on a {VIDEO_FRAMES}-frame 640x480 MJPG file: "
          f"{len(cli_times)} spans, p50 {np.percentile(cli_times, 50) * 1e3:.3f} ms; "
          f"run_camera card {json.dumps(card)}; CPU last {cpu['last_label']} "
          f"{cpu['last_prob']:.6f}")
    _require(len(cli_times) == VIDEO_FRAMES, f"one span a frame: {len(cli_times)}")
    _require(card["frames"] == cpu["frames"] == VIDEO_FRAMES, "every frame read")
    _require(card["last_label"] == cpu["last_label"]
             and abs(card["last_prob"] - cpu["last_prob"]) <= 1e-4,
             "run_camera's last prediction agrees with the CPU")


def _camera_report(path: str, dtype: str, times, gap: float, launches: dict,
                   timings: dict) -> None:
    import numpy as np

    tol = 1e-4 if dtype == "float32" else 2e-2
    fps = 1.0 / float(np.mean(times))
    p50 = float(np.percentile(times, 50) * 1e3)
    timings[f"camera_{path}_{dtype}"] = {"fps": fps, "p50_ms": p50}
    print(f"[camera] {dtype} {path} b1: {len(times)} frames, {fps:.1f} frames/s, p50 "
          f"{p50:.3f} ms, p90 {np.percentile(times, 90) * 1e3:.3f} ms; card vs CPU on frame 1 "
          f"{gap:.3e} of max|p| (tol {tol}); hand-written launches {launches}")
    _require(len(times) == CAMERA_FRAMES, f"{CAMERA_FRAMES} frames")
    _require(gap <= tol, f"camera {path} {dtype} agrees with the CPU: {gap}")
    _require(not any(launches.values()), f"the camera path launches no hand-written kernel: "
                                          f"{launches}")


def _rel_errs(got, want):
    """(max, RMS) of got - want, each relative to want's own scale."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = got - want
    return (float(np.abs(diff).max() / np.abs(want).max()),
            float(np.linalg.norm(diff) / np.linalg.norm(want)))


def _within(errs, dtype_name: str) -> bool:
    tol_max, tol_rms = TOL_MODEL[dtype_name]
    return errs[0] <= tol_max and errs[1] <= tol_rms


def _family3(tmp: str, norm: str):
    """The family-3 test model at the config defaults with ``norm``, seeded
    on the CPU, written as npz and read back onto the card by the CLI's
    loader; returns (card model, CPU model, config)."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli._common import load_multi_patchgan
    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )

    cfg = MultiPatchGANConfig(norm=norm)
    seeded = multiscale_test_init(torch.Generator().manual_seed(13), cfg.patch_sizes, ndf=cfg.ndf,
                                  num_classes=cfg.num_classes,
                                  gram_matrix_dim=cfg.gram_matrix_dim, norm=norm, device="cpu")
    ckpt = os.path.join(tmp, f"family3_{norm}.npz")
    save_pytree_npz(to_jax_tree(seeded), ckpt)
    return load_multi_patchgan(ckpt, cfg, torch.device(DEVICE)), seeded, cfg


def _family2(tmp: str):
    """The classification phase's family-2 model (written there as
    family2.npz), read onto the card by the CLI's loader; returns (card
    model, CPU model)."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import (
        load_gram_attention,
    )
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    seeded = gram_attention_init(torch.Generator().manual_seed(0), 8, 4, POOL_S, device="cpu")
    return (load_gram_attention(os.path.join(tmp, "family2.npz"), 8, 4, POOL_S,
                                torch.device(DEVICE)), seeded)


def phase_family3_classification(kernels, family3, timings: dict, tmp: str,
                                 n_batches: int) -> dict:
    """Family 3's ``--mode classification`` through the CLI's device loop
    (``evaluate``) and its JSON writer at b32, f32 and bf16; images/s from
    the per-batch spans; batch 0's logits and embeddings against the same
    model on the CPU. Every forward launches ``gram_fwd`` 16 times and,
    under norm "instance", ``instance_norm_fwd`` 13 times."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan import (
        classification_results,
        evaluate,
        write_classification_results,
    )
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_apply,
    )

    model, seeded, cfg = family3
    gdim, norm = cfg.gram_matrix_dim, cfg.norm
    batches = _batches(F3_BATCH * n_batches, F3_BATCH, seed=14)
    x0 = eval_preprocess(torch.from_numpy(batches[0]["image"]))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        compute = None if dtype == torch.float32 else dtype
        evaluate(model, batches[:1], gram_matrix_dim=gdim, norm=norm, compute_dtype=compute)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(model, batches, gram_matrix_dim=gdim, norm=norm, compute_dtype=compute,
                       measure_time=True)
        timings[f"family3_{norm}_{name}_s"] = time.perf_counter() - t0
        launches = kernels.launch_counts()
        results = classification_results(res)
        path = write_classification_results(results, os.path.join(tmp, f"family3_{norm}_{name}"))
        spans = [t for t, _ in res["spans"]]
        ips = F3_BATCH / float(np.median(spans))
        with torch.inference_mode():
            card = multiscale_test_apply(model, x0.to(DEVICE, dtype), gdim, norm)
            cpu = multiscale_test_apply(seeded, x0.to(dtype), gdim, norm)
        errs = {"logits": _rel_errs(card[1].float().cpu(), cpu[1].float()),
                "embeddings": _rel_errs(card[0].float().cpu(), cpu[0].float()),
                "gram_norms": _rel_errs(torch.stack(card[2]).float().cpu(),
                                        torch.stack(cpu[2]).float())}
        want = {"gram_fwd": F3_GRAMS * n_batches,
                "instance_norm_fwd": F3_NORMS * n_batches if norm == "instance" else 0}
        print(f"[family3_classification] norm {norm} {name} b{F3_BATCH}: "
              f"{F3_BATCH * n_batches} images, {ips:.1f} images/s (median of {len(spans)} batch "
              f"spans {[round(t * 1e3, 3) for t in spans]} ms), accuracy {results['accuracy']}, "
              f"predictions per class {np.bincount(results['predictions'], minlength=4).tolist()}; "
              f"card vs CPU on batch 0 (max, RMS) {json.dumps(errs)} (tol {TOL_MODEL[name]}); "
              f"launches {launches}")
        timings[f"family3_{norm}_{name}_images_per_s"] = ips
        out[name] = {"images_per_s": ips, "spans_ms": [t * 1e3 for t in spans], "errs": errs,
                     "launches": launches}
        _require(os.path.exists(path), "classification_results.json written")
        _require(len(results["predictions"]) == F3_BATCH * n_batches, "a prediction an image")
        _require(len(spans) == n_batches, f"one span a batch: {len(spans)}")
        _require(bool(torch.isfinite(card[1]).all()) and tuple(card[1].shape)
                 == (F3_BATCH, cfg.num_classes) and len(card[2]) == F3_GRAMS,
                 "finite logits of shape (32, 4) and 16 Gram norms")
        _require(all(_within(e, name) for e in errs.values()),
                 f"card agrees with the CPU: {errs}")
        _require(all(launches[k] == v for k, v in want.items()),
                 f"launches {want} for {n_batches} batches: {launches}")
    return out


def _samples_for(batches):
    """(path, label) records that a loader's batches index, for the image
    paths that the embedding task returns."""
    out = {}
    for b in batches:
        for i, label in zip(b["indices"], b["label"]):
            out[int(i)] = (f"img_{int(i):04d}.png", int(label))
    return [out[i] for i in sorted(out)]


def phase_embeddings(kernels, family1, family2, family3, tmp: str) -> dict:
    """``compute_embeddings_with_paths`` for families 1, 2 and 3 at full
    width over 2 batches each, card against CPU; family 1 also writes its
    ``<model>_embeddings.json``. t-SNE and HDBSCAN (scikit-learn, absent on
    the card machine) are held on the CPU by the tests."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import (
        write_embeddings_json,
    )
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        truncated_moco_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.embeddings import (
        compute_embeddings_with_paths,
    )

    f1_model, f1_seeded, _ = family1
    f2_model, f2_seeded = family2
    f3_model, f3_seeded, cfg = family3
    families = {
        "family1": (f1_model, f1_seeded, lambda m, x: truncated_moco_apply(m.moco, x, F1_TRUNCATE),
                    F1_BATCH, {}),
        "family2": (f2_model, f2_seeded,
                    lambda m, x: gram_attention_apply(m, x, 8, POOL_S, 4)[0], F2_BATCH,
                    {"pooled_gram_fwd": 4 * EMBED_BATCHES}),
        "family3": (f3_model, f3_seeded,
                    lambda m, x: multiscale_test_apply(m, x, cfg.gram_matrix_dim, cfg.norm)[0],
                    F3_BATCH, {"gram_fwd": F3_GRAMS * EMBED_BATCHES}),
    }
    out = {}
    for fam, (model, seeded, embed_fn, batch, want) in families.items():
        batches = _batches(batch * EMBED_BATCHES, batch, seed=15)
        samples = _samples_for(batches)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb, labels, paths = compute_embeddings_with_paths(embed_fn, model, batches, samples)
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        emb_cpu, labels_cpu, paths_cpu = compute_embeddings_with_paths(embed_fn, seeded, batches,
                                                                       samples)
        errs = _rel_errs(emb, emb_cpu)
        extra = ""
        if fam == "family1":
            path = write_embeddings_json(emb, labels, os.path.join(tmp, "family1.npz"), tmp)
            with open(path) as f:
                saved = json.load(f)
            _require(os.path.basename(path) == "family1_embeddings.json"
                     and len(saved["embeddings"]) == len(labels)
                     and saved["labels"] == labels.tolist(), f"{path} holds every embedding")
            extra = f", wrote {os.path.basename(path)}"
        print(f"[embeddings] {fam}: {emb.shape} in {seconds:.3f} s ({EMBED_BATCHES} batches of "
              f"{batch}); card vs CPU (max, RMS) {errs[0]:.3e}, {errs[1]:.3e} "
              f"(tol {TOL_MODEL['float32']}); launches {launches}{extra}")
        out[fam] = {"shape": list(emb.shape), "seconds": seconds, "errs": errs,
                    "launches": launches}
        _require(emb.shape[0] == batch * EMBED_BATCHES and paths == paths_cpu
                 and labels.tolist() == labels_cpu.tolist(), f"{fam}: every sample in order")
        _require(_within(errs, "float32"), f"{fam} embeddings agree with the CPU: {errs}")
        _require(all(launches[k] == want.get(k, 0) for k in launches),
                 f"{fam} launches {want}: {launches}")
    return out


def phase_family_cameras(kernels, family2, family3, timings: dict) -> dict:
    """The host-downscaled RGB camera path at b1, f32, for family 3 (16
    ``gram_fwd`` a frame) and family 2 (4 ``pooled_gram_fwd`` a frame at
    N = 1): F3_CAMERA_FRAMES frames each after one warm-up, p50 and
    frames/s, frame 1 against the CPU."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.camera import make_camera_infer_fn

    f2_model, f2_seeded = family2
    f3_model, f3_seeded, cfg = family3
    paths = {
        "family3": (f3_model, f3_seeded,
                    lambda m, x: multiscale_test_apply(m, x, cfg.gram_matrix_dim, cfg.norm)[1],
                    {"gram_fwd": F3_GRAMS}),
        "family2": (f2_model, f2_seeded, lambda m, x: gram_attention_apply(m, x, 8, POOL_S, 4)[1],
                    {"pooled_gram_fwd": 4}),
    }
    frames = _camera_frames(16)["rgb224"][: F3_CAMERA_FRAMES + 1]
    out = {}
    for fam, (model, seeded, forward, per_frame) in paths.items():
        infer = make_camera_infer_fn(forward, host_downscale=True)
        infer(model, frames[0]).cpu()  # warm-up
        kernels.reset_launch_counts()
        probs, times = [], []
        for f in frames[1:]:
            t0 = time.perf_counter()
            probs.append(infer(model, f).cpu())
            times.append(time.perf_counter() - t0)
        launches = kernels.launch_counts()
        errs = _rel_errs(probs[0], infer(seeded, frames[1]))
        p50 = float(sorted(times)[len(times) // 2] * 1e3)
        fps = len(times) / sum(times)
        timings[f"{fam}_camera_float32"] = {"fps": fps, "p50_ms": p50}
        print(f"[{fam}_camera] float32 rgb_host_downscale b1: {len(times)} frames, {fps:.1f} "
              f"frames/s, p50 {p50:.3f} ms; card vs CPU on frame 1 (max, RMS) {errs[0]:.3e}, "
              f"{errs[1]:.3e} (tol {TOL_MODEL['float32']}); launches {launches}")
        out[fam] = {"fps": fps, "p50_ms": p50, "times_ms": [t * 1e3 for t in times],
                    "errs": errs, "launches": launches}
        _require(len(times) == F3_CAMERA_FRAMES, f"{F3_CAMERA_FRAMES} frames")
        _require(_within(errs, "float32"), f"{fam} camera agrees with the CPU: {errs}")
        _require(all(launches[k] == v * F3_CAMERA_FRAMES for k, v in per_frame.items()),
                 f"{fam} launches {per_frame} a frame: {launches}")
    return out


def _gradient_guards(kg, kin) -> None:
    """The forward-only wrappers refuse a CUDA input that needs a gradient
    (their outputs carry no graph): ``gram_fwd`` names ``GramFunction``,
    ``instance_norm_fwd`` its own limit; the Functions take such inputs."""
    import torch

    f = torch.rand((1, 16, 64), device=DEVICE, requires_grad=True)
    x = torch.rand((1, 16, 64), device=DEVICE, requires_grad=True)
    ones, zeros = torch.ones((1, 64), device=DEVICE), torch.zeros((1, 64), device=DEVICE)
    refused = []
    for name, call in (("gram_fwd", lambda: kg.gram_fwd(f)),
                       ("pooled_gram_fwd", lambda: kg.pooled_gram_fwd(f, 7)),
                       ("instance_norm_fwd", lambda: kin.instance_norm_fwd(x, ones, zeros))):
        try:
            call()
        except NotImplementedError as e:
            refused.append((name, str(e)))
    print(f"[kernels] forward-only wrappers on inputs that need a gradient: {refused}")
    _require(len(refused) == 3 and "GramFunction" in refused[0][1]
             and "PooledGramFunction" in refused[1][1],
             f"gram_fwd, pooled_gram_fwd and instance_norm_fwd refuse inputs that need a "
             f"gradient: {refused}")
    g = kg.GramFunction.apply(f)
    pg = kg.PooledGramFunction.apply(f, 7)
    y = kin.InstanceNormFunction.apply(x, ones, zeros, kin.EPS, True)
    (df,) = torch.autograd.grad(g.sum(), f)
    (dpf,) = torch.autograd.grad(pg.sum(), f)
    (dx,) = torch.autograd.grad(y.sum(), x)
    _require(bool(torch.isfinite(df).all() and torch.isfinite(dpf).all()
                  and torch.isfinite(dx).all()),
             "GramFunction, PooledGramFunction and InstanceNormFunction differentiate on the card")


def _bwd_check(got, want, dname: str):
    """({name: [max rel, rms]}, ok) of instance_norm_bwd's (dx, dscale,
    dbias) against its plain version's, each relative to the plain
    result's own scale, at TOL."""
    import torch

    errs, ok = {}, True
    for name, a, wnt in zip(("dx", "dscale", "dbias"), got, want):
        diff = a.double() - wnt.double()
        rel = (diff.abs().max() / wnt.double().abs().max()).item()
        rms = (diff.norm() / wnt.double().norm()).item()
        errs[name] = [rel, rms]
        ok = ok and bool(torch.isfinite(a.float()).all()) and rel <= TOL[dname] \
            and rms <= TOL[dname]
    return errs, ok


def _forced_in_bwd_checks(kin) -> list:
    """instance_norm_bwd's cluster route forced onto ragged plans (a partial
    last channel group, 16-byte groups, k = 1, 3 and 16 at an odd HW, a
    prime HW over 5 blocks), with ReLU and affine rows, each against the
    plain version at TOL; a misaligned bf16 input, which the plan sends to
    the split route, and which the cluster route, forced, refuses. Not
    timed; outside the main path's launch counts."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    out = []
    for (b, h, w, c), dtype in [((3, 37, 29, 48), torch.float32),
                                ((3, 37, 29, 48), torch.bfloat16),
                                ((2, 1, 1009, 16), torch.float32)]:
        hw, es = h * w, torch.tensor([], dtype=dtype).element_size()
        v = 16 // es
        x = (torch.randn((b, hw, c), device=dev, generator=gen) * 2 + 0.5).to(dtype)
        dy = torch.randn((b, hw, c), device=dev, generator=gen).to(dtype)
        scale = torch.randn((b, c), device=dev, generator=gen)
        bias = torch.randn((b, c), device=dev, generator=gen)
        y = kin.instance_norm_fwd(x, scale, bias, relu=True)
        want = kin.instance_norm_bwd_plain(x, dy, scale, bias, relu=True, y=y)
        for g, k in ((32, 3), (2 * v, 1), (v, 16), (2 * v, 5)):
            plan = kin.BwdPlan("cluster", g, k)
            got = kin.instance_norm_bwd(x, dy, scale, bias, relu=True, y=y, _plan=plan)
            torch.cuda.synchronize()
            errs, ok = _bwd_check(got, want, str(dtype).split(".")[1])
            out.append(dict(shape=[b, h, w, c], dtype=str(dtype).split(".")[1], g=g, k=k,
                            errs=errs, ok=ok))
    flat = torch.randn((1 + 2 * 99 * 24,), device=dev, generator=gen).to(torch.bfloat16)
    x = flat[1:].view(2, 99, 24)  # 2 bytes past a 16-byte boundary
    dy = torch.randn((2, 99, 24), device=dev, generator=gen).to(torch.bfloat16)
    ones, zeros = torch.ones((2, 24), device=dev), torch.zeros((2, 24), device=dev)
    plan = kin.instance_norm_bwd_plan_for(x, False, dy)
    forced = kin.BwdPlan("cluster", 16, 2)
    try:
        kin.instance_norm_bwd(x, dy, ones, zeros, _plan=forced)
        refused = False
    except RuntimeError:
        refused = True
    out.append(dict(shape=[2, 1, 99, 24], dtype="bfloat16", misaligned=True,
                    route=plan.route, cluster_refused=refused,
                    ok=plan.route == "split" and refused))
    for r in out:
        print(f"[kernels] instance_norm_bwd forced {r['dtype']} {tuple(r['shape'])} "
              + (f"misaligned: plan route={r['route']}, cluster forced refused="
                 f"{r['cluster_refused']}" if r.get("misaligned") else
                 f"cluster G={r['g']} k={r['k']}: (max, rms) rel "
                 + " ".join(f"{k}=({e[0]:.2e}, {e[1]:.2e})" for k, e in r["errs"].items()))
              + f" ok={r['ok']}")
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise RuntimeError(f"instance_norm_bwd forced checks failed: {bad}")
    return out


def phase_in_bwd_kernels(kin, peaks) -> list:
    """instance_norm_bwd against its plain version (dx, dscale and dbias,
    each max-relative and RMS, 1e-4 f32 and 2e-2 bf16) at the family-3 style
    loop's B = 1 shapes and at (32,112,112,64) (ReLU, unit scale, zero bias,
    the mask from the forward's output), and at the fast-style net's B = 8
    shapes with affine rows that differ per image, with and without ReLU;
    f32 and bf16. Each row names the route the plan took (cluster or
    split), its cluster size k, channel group G, the clusters the card holds
    at once and the bytes read a second time; the B = 1 rows also run the
    split route, forced, held to the same checks and timed (``split_ms``).
    Two calls on each route must give bit-equal dx, dscale and dbias. Each
    row times the kernel, the plain version and the library:
    ``torch.autograd.grad`` through ``F.instance_norm`` (+ ReLU) with one
    (C,) affine, its forward's time taken off; the bound is x, dy (and y
    under ReLU) read once and dx written once at the card's HBM rate."""
    import torch
    import torch.nn.functional as F

    def repeatable(call) -> bool:
        first, second = call(), call()
        return all(torch.equal(a, b) for a, b in zip(first, second))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    cases = [(shape, dtype, True, "unit affine") for shape in F3_STYLE_IN_SHAPES
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(shape, dtype, relu, "affine rows") for shape in NET_IN_BWD_SHAPES + B16_IN_SHAPES
              for dtype in (torch.float32, torch.bfloat16) for relu in (False, True)]
    cases += [(shape, dtype, False, "unit affine") for shape in F3T_IN_SHAPES
              for dtype in (torch.float32, torch.bfloat16)]
    rows = []
    for (b, h, w, c), dtype, relu, kind in cases:
        hw = h * w
        dname = str(dtype).split(".")[1]
        x = (torch.randn((b, hw, c), device=dev, generator=g) * 2 + 0.5
             + torch.randn((c,), device=dev, generator=g)).to(dtype)
        dy = torch.randn((b, hw, c), device=dev, generator=g).to(dtype)
        if kind == "unit affine":
            scale = torch.ones((b, c), device=dev)
            bias = torch.zeros((b, c), device=dev)
        else:
            scale = torch.randn((b, c), device=dev, generator=g)
            bias = torch.randn((b, c), device=dev, generator=g)
        y = kin.instance_norm_fwd(x, scale, bias, relu=relu) if relu else None
        plan = kin.instance_norm_bwd_plan_for(x, relu, dy, y)
        got = kin.instance_norm_bwd(x, dy, scale, bias, relu=relu, y=y)
        want = kin.instance_norm_bwd_plain(x, dy, scale, bias, relu=relu, y=y)
        torch.cuda.synchronize()
        errs, ok = _bwd_check(got, want, dname)
        same = repeatable(lambda: kin.instance_norm_bwd(x, dy, scale, bias, relu=relu, y=y))
        es = x.element_size()
        tensors_in = 3 if relu else 2  # x, dy (and y)
        extra = {}
        if plan.route == "cluster":
            blocks = b * -(-c // plan.g) * plan.k
            reread = 0
        else:
            width = 16 // es
            _, _, splits, groups = kin._geometry(c, hw, width if c % width == 0 else 1,
                                                 kin._BWD_ITEMS)
            blocks = splits * groups * b
            reread = tensors_in * b * hw * c * es
        if b == 1:  # the split route, forced, on the same inputs

            def split():
                return kin.instance_norm_bwd(x, dy, scale, bias, relu=relu, y=y,
                                             _plan=kin.BWD_SPLIT)

            extra["split_errs"], split_ok = _bwd_check(split(), want, dname)
            extra["split_repeatable"] = repeatable(split)
            extra["split_ms"] = _time_ms(split)
            ok = ok and split_ok and extra["split_repeatable"]
        ok = ok and same
        # 1 read of x, dy (and y), 1 write of dx, the (B, C) rows; about 12
        # f32 operations an element over the two passes, on CUDA cores
        bound, by = _bound(12.0 * b * hw * c, (tensors_in + 1) * b * hw * c * es + 3 * b * c * 4,
                           torch.float32, peaks)
        x4 = x.view(b, h, w, c).permute(0, 3, 1, 2).detach().requires_grad_(True)
        dy4 = dy.view(b, h, w, c).permute(0, 3, 1, 2)
        s0 = scale[0].clone().requires_grad_(True)
        b0 = bias[0].clone().requires_grad_(True)

        def lib_fwd():
            out = F.instance_norm(x4, weight=s0, bias=b0, eps=kin.EPS)
            return torch.relu(out) if relu else out

        lib_fwd_ms = _time_ms(lib_fwd)
        lib_both_ms = _time_ms(lambda: torch.autograd.grad(lib_fwd(), (x4, s0, b0), dy4))
        rows.append(dict(
            shape=[b, h, w, c], dtype=dname, relu=relu, input=kind, errs=errs,
            max_abs_err=(got[0].double() - want[0].double()).abs().max().item(),
            tol=TOL[dname], ok=ok, repeatable=same, route=plan.route, k=plan.k, g=plan.g,
            clusters=plan.clusters, blocks=blocks, reread_bytes=reread, plan=plan._asdict(),
            ms=_time_ms(lambda: kin.instance_norm_bwd(x, dy, scale, bias, relu=relu, y=y)),
            plain_ms=_time_ms(lambda: kin.instance_norm_bwd_plain(x, dy, scale, bias,
                                                                  relu=relu, y=y)),
            library_ms=lib_both_ms - lib_fwd_ms, library_fwd_bwd_ms=lib_both_ms,
            bound_ms=bound, bound_by=by, **extra))
        del x, dy, y, got, want, x4, dy4
    for r in rows:
        print(f"[kernels] instance_norm_bwd {r['dtype']} {tuple(r['shape'])} relu={r['relu']} "
              f"{r['input']}: route={r['route']} k={r['k']} G={r['g']} clusters={r['clusters']} "
              f"blocks={r['blocks']} reread_bytes={r['reread_bytes']} "
              f"repeatable={r['repeatable']} (max, rms) rel "
              + " ".join(f"{k}=({v[0]:.2e}, {v[1]:.2e})" for k, v in r["errs"].items())
              + f" (tol {r['tol']}) ms={r['ms']:.4f} "
              + (f"split_ms={r['split_ms']:.4f} split (max, rms) rel "
                 + " ".join(f"{k}=({v[0]:.2e}, {v[1]:.2e})" for k, v in r["split_errs"].items())
                 + f" split_repeatable={r['split_repeatable']} " if "split_ms" in r else "")
              + f"plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} (fwd+bwd {r['library_fwd_bwd_ms']:.4f}) "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    bad = [(r["dtype"], r["shape"], r["relu"]) for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"instance_norm_bwd disagrees with its plain version: {bad}")
    return rows


def phase_pooled_bwd_kernels(kg, peaks) -> list:
    """pooled_gram_bwd against pooled_gram_bwd_plain from the same Y (the
    forward kernel's, ``pooled_gram_fwd(..., return_y=True)``), f32 and
    bf16, at the family-2 training step's b32 stage outputs (truncate 7,
    S 7), at overlapping bins (C = 10), C < S, S = 24, S = 64 and odd C, on
    non-negative features and a signed, non-symmetric dG: max|err| and RMS,
    each relative to the plain result's scale, at TOL; two calls bit-equal.
    Each row names the store mode the plan chose, its tile rows and blocks,
    and times the kernel, the plain version and the library yardstick:
    autograd through the two-einsum composition (Y = F P^T, G = Y^T Y /
    HW), its forward's time taken off. The bound: Y and dG read once, dF
    written once at the card's HBM rate, or the f32 operations (S^2 FMAs
    and up to C adds a row) on the CUDA cores; ``old_bound_ms`` is that of
    a backward that reads F in Y's place."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.ops.pooling import adaptive_pool_matrix

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(60)
    cases = [(shape, POOL_S) for shape in B32_POOLED_SHAPES] + POOLED_BWD_EXTRA
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        es = torch.tensor([], dtype=dtype).element_size()
        for (n, h, w, c), s in cases:
            hw = h * w
            f = torch.relu(torch.randn((n, hw, c), device=dev, generator=gen)).to(dtype)
            dg = torch.randn((n, s, s), device=dev, generator=gen).to(dtype)
            _, y = kg.pooled_gram_fwd(f, s, return_y=True)
            got = kg.pooled_gram_bwd(y, dg, c, dtype)
            want = kg.pooled_gram_bwd_plain(y, dg, c, dtype)
            torch.cuda.synchronize()
            diff = got.float() - want.float()
            err = diff.abs().max().item()
            rel = err / want.float().abs().max().item()
            rms = (diff.norm() / want.float().norm()).item()
            same = torch.equal(kg.pooled_gram_bwd(y, dg, c, dtype),
                               kg.pooled_gram_bwd(y, dg, c, dtype))
            ok = (bool(torch.isfinite(got.float()).all()) and rel <= TOL[dname]
                  and rms <= TOL[dname] and same)
            plan = kg.pooled_gram_bwd_plan_for(y, c, dtype)
            flops = n * hw * (2.0 * s * s + c)
            bound, by = _bound(flops, n * hw * s * 4 + (n * s * s + n * hw * c) * es,
                               torch.float32, peaks)
            old_bound, _ = _bound(flops, (2 * n * hw * c + n * s * s) * es, torch.float32, peaks)
            pl = adaptive_pool_matrix(c, s, dev).to(dtype)
            fl = f.detach().clone().requires_grad_(True)

            def lib_fwd():
                yl = torch.einsum("nkc,oc->nko", fl, pl)
                return torch.einsum("nko,nkp->nop", yl, yl) / hw

            lib_fwd_ms = _time_ms(lib_fwd)
            lib_both_ms = _time_ms(lambda: torch.autograd.grad(lib_fwd(), fl, dg))
            rows.append(dict(
                shape=[n, h, w, c], s=s, dtype=dname, max_abs_err=err, rel_err=rel, rms_err=rms,
                tol=TOL[dname], ok=ok, repeatable=same, mode=plan.mode,
                tile_rows=plan.tile_rows, blocks=plan.blocks, smem=plan.smem,
                ms=_time_ms(lambda: kg.pooled_gram_bwd(y, dg, c, dtype)),
                plain_ms=_time_ms(lambda: kg.pooled_gram_bwd_plain(y, dg, c, dtype)),
                library_ms=lib_both_ms - lib_fwd_ms, library_fwd_bwd_ms=lib_both_ms,
                bound_ms=bound, bound_by=by, old_bound_ms=old_bound))
            del f, dg, y, got, want, fl
    for r in rows:
        print(f"[kernels] pooled_gram_bwd {r['dtype']} {tuple(r['shape'])} S={r['s']} "
              f"mode={r['mode']} tile_rows={r['tile_rows']} blocks={r['blocks']}: "
              f"max_abs_err={r['max_abs_err']:.3e} rel={r['rel_err']:.3e} rms={r['rms_err']:.3e} "
              f"(tol {r['tol']}) repeatable={r['repeatable']} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (fwd+bwd "
              f"{r['library_fwd_bwd_ms']:.4f}) bound_ms={r['bound_ms']:.4f} ({r['bound_by']}: Y, "
              f"dG, dF) old_bound_ms={r['old_bound_ms']:.4f} (F, dG, dF)")
    bad = [(r["dtype"], r["shape"], r["s"]) for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"pooled_gram_bwd disagrees with its plain version: {bad}")
    return rows


def phase_pooled_fwd_y(kg) -> list:
    """pooled_gram_fwd's Y (``return_y=True``) on the bulk, scalar and
    project routes against ``pooled_gram_y_plain``, f32 and bf16 (Y is f32
    either way, so TOL's f32 bound holds both), with the Gram it returns
    bit-equal to the call without Y; the forward timed without and with Y."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(61)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for (n, h, w, c), s in POOLED_Y_CASES:
            f = torch.relu(torch.randn((n, h * w, c), device=dev, generator=gen)).to(dtype)
            g0 = kg.pooled_gram_fwd(f, s)
            g1, y = kg.pooled_gram_fwd(f, s, return_y=True)
            want = kg.pooled_gram_y_plain(f, s)
            torch.cuda.synchronize()
            diff = y - want
            rel = (diff.abs().max() / want.abs().max()).item()
            rms = (diff.norm() / want.norm()).item()
            same = torch.equal(g0, g1)
            ok = (y.dtype == torch.float32 and tuple(y.shape) == (n, h * w, s)
                  and rel <= TOL["float32"] and rms <= TOL["float32"] and same)
            rows.append(dict(
                shape=[n, h, w, c], s=s, dtype=dname, route=kg.pooled_gram_route_for(f, s),
                y_rel_err=rel, y_rms_err=rms, tol=TOL["float32"], gram_same=same, ok=ok,
                ms=_time_ms(lambda: kg.pooled_gram_fwd(f, s)),
                y_ms=_time_ms(lambda: kg.pooled_gram_fwd(f, s, return_y=True))))
            del f, g0, g1, y, want
    for r in rows:
        print(f"[kernels] pooled_gram_fwd Y {r['dtype']} {tuple(r['shape'])} S={r['s']} "
              f"route={r['route']}: Y against the plain Y rel={r['y_rel_err']:.3e} "
              f"rms={r['y_rms_err']:.3e} (tol {r['tol']}), Gram bit-equal without Y "
              f"{r['gram_same']}; ms without Y {r['ms']:.4f}, with Y {r['y_ms']:.4f}")
    bad = [(r["dtype"], r["shape"], r["s"]) for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"pooled_gram_fwd's Y disagrees with the plain Y: {bad}")
    return rows


def phase_family3_style_transfer(kernels, family3, timings: dict, tmp: str) -> dict:
    """Family 3's ``--mode style_transfer`` through ``style_transfer_patches``
    (what the CLI calls, with its b1 loader) at full width: f32 and bf16 at
    norm "batch", f32 at norm "instance"; 2 images of 20 iterations at
    threshold 0. Checks every launch count, then image 0 again on the card
    and on the CPU from the same noise: the first step's pixel gradient,
    and a loop of F3_STYLE_CPU_ITERS iterations towards the image's Gram plus an offset
    that makes the pixels move (every iteration's loss, and the pixels'
    change); and the device idle share over 5 profiled iterations."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_gram_fn_patches,
        make_style_transfer_optimizer,
        style_transfer_patches,
    )
    from heuristique_style_transfer_code_tpu_torch.tools.profile_main_path import _profile

    out = {}
    batches = _batches(F3_STYLE_IMAGES, 1, seed=17)
    n, iters = F3_STYLE_IMAGES, F3_STYLE_ITERS
    for norm, dtype in (("batch", torch.float32), ("batch", torch.bfloat16),
                        ("instance", torch.float32)):
        model, seeded, cfg = family3[norm]
        gdim = cfg.gram_matrix_dim
        name = str(dtype).split(".")[1]
        compute = None if dtype == torch.float32 else dtype
        quiet = lambda msg: None  # noqa: E731
        style_transfer_patches(model, batches[:1], os.path.join(tmp, "f3_style_warm"),
                               gram_matrix_dim=gdim, norm=norm, threshold=0.0,
                               num_iterations=2, compute_dtype=compute, log_fn=quiet)
        history = []
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = style_transfer_patches(
            model, batches, os.path.join(tmp, f"f3_style_{norm}_{name}"), gram_matrix_dim=gdim,
            norm=norm, threshold=0.0, num_iterations=iters, compute_dtype=compute,
            generator=torch.Generator().manual_seed(18), history=history, log_fn=quiet)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        inst = norm == "instance"
        want = {"gram_fwd": n * F3_GRAMS * (iters + 1), "gram_bwd": n * F3_GRAMS * iters,
                "pooled_gram_fwd": 0, "pooled_gram_bwd": 0,
                "instance_norm_fwd": n * F3_NORMS * (iters + 1) if inst else 0,
                "instance_norm_bwd": n * F3_NORMS * iters if inst else 0}

        gram_fn = make_gram_fn_patches(model, gdim, norm, compute)
        x0 = eval_preprocess(torch.from_numpy(batches[0]["image"]))
        noise0 = torch.randn(x0.shape, generator=torch.Generator().manual_seed(18))
        with torch.no_grad():
            targets = gram_fn(x0.to(DEVICE))
        prof = _profile(lambda: make_style_transfer_optimizer(gram_fn, F3_STYLE_LR, 5, 0.0)(
            noise0.to(DEVICE), targets), 1)
        # image 0's loop on the card and on the CPU from the same noise
        cpu_fn = make_gram_fn_patches(seeded, gdim, norm, compute)
        nudged = noise0 * (1 + F3_STYLE_NUDGE * torch.randn(
            noise0.shape, generator=torch.Generator().manual_seed(20)))
        sides = [("card", gram_fn, targets, DEVICE, noise0)]
        with torch.no_grad():
            sides.append(("cpu", cpu_fn, cpu_fn(x0), "cpu", noise0))
            if compute is None:  # the CPU's own spread: the f32 yardstick
                sides.append(("cpu_nudged", cpu_fn, sides[-1][2], "cpu", nudged))
            else:  # the same loop in f32 on the CPU: the bf16 yardstick
                fn32 = make_gram_fn_patches(seeded, gdim, norm)
                sides.append(("cpu_f32", fn32, fn32(x0), "cpu", noise0))
        r = torch.randn((1, cfg.ndf, cfg.ndf), generator=torch.Generator().manual_seed(19))
        offset = F3_STYLE_OFFSET * (r + r.transpose(1, 2)) / 2
        grads, losses, moves = {}, {}, {}
        t_cpu = time.perf_counter()
        for side, fn, tg, dev, start in sides:
            if side != "cpu_nudged":
                nz = start.detach().to(dev).requires_grad_(True)
                loss = torch.mean(torch.square(fn(nz)[0] - tg[0]), dim=(1, 2)).sum()
                (grads[side],) = torch.autograd.grad(loss, nz)
            h = []
            final = make_style_transfer_optimizer(fn, F3_STYLE_LR, F3_STYLE_CPU_ITERS, 0.0)(
                start.to(dev), [tg[0] + offset.to(dev)], h)[0]
            moves[side] = final.cpu() - start
            losses[side] = torch.stack([p.cpu() for p in h])
        t_cpu = time.perf_counter() - t_cpu
        g_errs = _rel_errs(grads["card"].cpu(), grads["cpu"])
        move_errs = _rel_errs(moves["card"], moves["cpu"])
        loss_err = ((losses["card"] - losses["cpu"]).abs() / losses["cpu"].abs()).max().item()
        moved = moves["cpu"].abs().max().item()
        # f32: pixels crossing the discriminators' ReLU kinks make the loop
        # chaotic. Starting the CPU's own loop from noise nudged by 1e-7 (f32
        # rounding's size) moves single pixels by 0.4% of the largest change
        # at norm "batch" and 3% at "instance" (RMS 2e-4 and 4e-3) within 20
        # iterations, so the card's pixel change is held by RMS to the larger
        # of TOL_MODEL's and twice that spread, and its max only reported.
        # bf16: the card and the CPU round at other places through 16 convs
        # forward and back, each about 4% (RMS) from the f32 gradient; the
        # card's bf16 gradient and pixel change are held to 1.5 times the
        # CPU's own bf16 error against the f32 ones (RMS), as the CPU tests
        # hold bf16 embeddings
        spread = _rel_errs(moves["cpu_nudged"], moves["cpu"]) if compute is None else None
        g32_errs, move32_errs = (
            ({side: _rel_errs(grads[side].cpu(), grads["cpu_f32"]) for side in ("card", "cpu")},
             {side: _rel_errs(moves[side], moves["cpu_f32"]) for side in ("card", "cpu")})
            if compute is not None else (None, None))
        ips = n * iters / seconds
        first = [h[0].item() for h in history]
        last = [h[-1].item() for h in history]
        print(f"[family3_style_transfer] norm {norm} {name} b1: {n} images x {iters} "
              f"iterations in {seconds:.3f} s, launches {launches}; losses it1 {first} -> "
              f"it{iters} {last}; card vs CPU on image 0: first-step pixel gradient (max, RMS) "
              f"{[round(e, 9) for e in g_errs]}; offset-target loop: pixels moved up to "
              f"{moved:.4f} (lr {F3_STYLE_LR}), pixel change (max, RMS) "
              f"{[round(e, 9) for e in move_errs]} "
              + (f"(the CPU's own spread from noise nudged by {F3_STYLE_NUDGE}: {spread}; "
                 f"RMS tol max({TOL_MODEL[name][1]}, 2x the spread's))" if compute is None else
                 f"(against the CPU's f32 loop: gradient card {g32_errs['card']}, CPU "
                 f"{g32_errs['cpu']}; pixel change card {move32_errs['card']}, CPU "
                 f"{move32_errs['cpu']}; tol 1.5x the CPU's RMS)")
              + f", all {F3_STYLE_CPU_ITERS} losses rel {loss_err:.3e} (tol "
              f"{TOL_MODEL[name][0]}); "
              f"CPU loops and gradients {t_cpu:.1f} s")
        print(f"[family3_style_transfer] norm {norm} {name}: {ips:.2f} image-iterations/s, "
              f"device idle share {prof['idle_share']:.3f} over 5 profiled iterations "
              f"(busy {prof['device_busy_ms']:.3f} of {prof['window_ms']:.3f} ms; Gram kernels "
              f"{prof['gram_share_of_busy']:.4f} of busy, instance-norm kernels "
              f"{prof['instance_norm_share_of_busy']:.4f})")
        timings[f"family3_style_{norm}_{name}_s"] = seconds
        out[f"{norm}_{name}"] = {
            "image_iterations_per_s": ips, "seconds": seconds, "launches": launches,
            "gradient_errs": g_errs, "gradient_errs_vs_f32": g32_errs,
            "loss_rel_err": loss_err, "pixel_change_errs": move_errs,
            "pixel_change_errs_vs_f32": move32_errs, "pixel_change_spread": spread,
            "pixels_moved": moved,
            "first_losses": first, "last_losses": last, "profile": prof}
        _require(launches == want, f"launches {want} for {n} images of {iters} iterations: "
                 f"{launches}")
        _require(len(saved) == n and all(os.path.exists(p) for p in saved), f"{n} PNGs written")
        _require(all(len(h) == iters for h in history), f"{iters} iterations an image")
        _require(all(np.isfinite(first + last)), f"finite losses: {first}, {last}")
        _require(_within(g_errs, name) if compute is None
                 else g32_errs["card"][1] <= 1.5 * g32_errs["cpu"][1],
                 f"card pixel gradient agrees with the CPU: {g_errs}, {g32_errs}")
        _require(moved >= F3_STYLE_LR, f"the offset-target loop moved pixels: {moved}")
        _require(move_errs[1] <= max(TOL_MODEL[name][1], 2 * spread[1]) if compute is None
                 else move32_errs["card"][1] <= 1.5 * move32_errs["cpu"][1],
                 f"card pixel change agrees with the CPU: {move_errs}, {spread}, {move32_errs}")
        _require(loss_err <= TOL_MODEL[name][0],
                 f"all {iters} losses agree with the CPU: {loss_err}")
    return out


def phase_pth(family1, family2, family3, tmp: str) -> dict:
    """Reference ``.pth`` checkpoints at full width: each family's seeded
    model (family 3 the test variant, norm "batch") through ``to_jax_tree``,
    the port's exporter and ``torch.save``; read back through the CLI's
    ``load_checkpoint_tree(path, family, config)`` and its loader onto the
    card, where its logits must equal the ``.npz``-loaded model's bit for
    bit. Then ``convert_checkpoint`` npz -> pth -> npz of each, which must
    give back the same tree."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.checkpoint.pth_exporter import (
        export_checkpoint_tree,
        save_pth,
    )
    from heuristique_style_transfer_code_tpu_torch.cli._common import (
        load_checkpoint_tree,
        load_multi_patchgan,
        load_truncated_resnet50,
    )
    from heuristique_style_transfer_code_tpu_torch.cli.convert_checkpoint import main as convert
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import (
        load_gram_attention,
    )
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_apply,
    )

    dev = torch.device(DEVICE)
    x = eval_preprocess(torch.from_numpy(_batches(8, 8, seed=19)[0]["image"]).to(dev))
    f3_model, f3_seeded, f3_cfg = family3["batch"]
    cases = {
        "truncated_resnet50": (family1[1], family1[0], {}, os.path.join(tmp, "family1.npz"),
                               lambda p, t: load_truncated_resnet50(p, F1_TRUNCATE, dev, tree=t),
                               lambda m: family1[2](m, x)),
        "gram_attention": (family2[1], family2[0], {}, os.path.join(tmp, "family2.npz"),
                           lambda p, t: load_gram_attention(p, 8, 4, POOL_S, dev, tree=t),
                           lambda m: gram_attention_apply(m, x, 8, POOL_S, 4)[1]),
        "multi_patchgan_test": (f3_seeded, f3_model, f3_cfg.to_dict(),
                                os.path.join(tmp, "family3_batch.npz"),
                                lambda p, t: load_multi_patchgan(p, f3_cfg, dev, tree=t),
                                lambda m: multiscale_test_apply(m, x, f3_cfg.gram_matrix_dim,
                                                                "batch")[1]),
    }
    out = {}
    for family, (seeded, npz_model, config, npz, load, logits_of) in cases.items():
        pth = os.path.join(tmp, f"{family}.pth")
        save_pth(export_checkpoint_tree(to_jax_tree(seeded), family, config), pth)
        model = load(pth, load_checkpoint_tree(pth, family, config))
        with torch.inference_mode():
            got, want = logits_of(model), logits_of(npz_model)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        cfg_path = os.path.join(tmp, f"{family}_cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        back = os.path.join(tmp, f"{family}_back.npz")
        convert(["--family", family, "--input", npz, "--output",
                 os.path.join(tmp, f"{family}_cli.pth"), "--config", cfg_path])
        convert(["--family", family, "--input", os.path.join(tmp, f"{family}_cli.pth"),
                 "--output", back, "--config", cfg_path])
        fa, fb = _flatten(load_pytree_npz(npz)), _flatten(load_pytree_npz(back))
        same = sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)
        print(f"[pth] {family}: {os.path.getsize(pth)} bytes; logits {tuple(got.shape)} from the "
              f".pth equal the .npz model's bit for bit: {equal}; convert_checkpoint npz -> pth "
              f"-> npz gives back {len(fa)} leaves: {same}")
        out[family] = {"pth_bytes": os.path.getsize(pth), "logits_equal": equal,
                       "roundtrip_equal": same}
        _require(equal and bool(torch.isfinite(got).all()),
                 f"{family}: .pth logits equal the .npz model's")
        _require(same, f"{family}: convert_checkpoint npz -> pth -> npz is an identity")
    return out


def _image_folder(root: str, per_class: int, seed: int, size=(256, 256),
                  split: str = "test") -> str:
    """An ImageFolder split of random PNGs, ``per_class`` under each of the
    four weather classes; returns ``root``."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    for cls in ("fog", "rain", "snow", "sun"):
        d = os.path.join(root, split, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            Image.fromarray(rng.randint(0, 256, size + (3,)).astype(np.uint8)).save(
                os.path.join(d, f"img_{i:03d}.png"))
    return root


def _real_cam(cam) -> bool:
    """A CAM (before the resize) whose min-max spans [0, 1] with pixels
    strictly inside: its range was above the normalisation's 1e-7 floor."""
    import numpy as np

    cam = np.asarray(cam)
    inside = float(((cam > 0.01) & (cam < 0.99)).mean())
    return abs(float(cam.max()) - 1.0) <= 1e-6 and inside > 0.02


def phase_gradcam(kernels, family1, tmp: str, timings: dict) -> dict:
    """Family 1's ``--mode classification`` through its CLI with
    ``--save_test_images --visualize_gradcam --save_gradcam_images
    --tensorboard`` on 8 images (b4, two batches) on the card: every overlay
    written at 224 x 672 x 3, the card's CAMs against the CPU's on the same
    model and images, ms per CAM, and whether TensorBoard wrote its log
    (a machine without it prints the JAX CLI's warning and goes on).

    The CLI draws confusion_matrix.png with matplotlib after the PNG tree,
    the overlays and metrics.txt, as the JAX CLI does. Where matplotlib is
    not installed, the CLI stops there with ModuleNotFoundError for it, and
    only then: that one error is expected, and everything written before it
    is checked; with matplotlib the CLI must run to its end and write the
    plot."""
    import importlib.util

    import cv2
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import main as cli
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.data.loader import load_image_staged
    from heuristique_style_transfer_code_tpu_torch.tasks.gradcam import _cam_for_moco, gradcam_moco

    model, seeded, _ = family1
    data = _image_folder(os.path.join(tmp, "gradcam_data"), GRADCAM_IMAGES // 4, seed=23,
                         size=(240, 320))
    cfg = os.path.join(tmp, "family1.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": GRADCAM_BATCH, "truncate_layer": F1_TRUNCATE, "dim": F1_DIM,
                   "seed": 0}, f)
    out = os.path.join(tmp, "gradcam_out")
    have_matplotlib = importlib.util.find_spec("matplotlib") is not None
    stopped_at_plot = False
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        cli(["--data", data, "--config_path", cfg, "--model_path",
             os.path.join(tmp, "family1.npz"), "--mode", "classification", "--save_dir", out,
             "--batch_size", str(GRADCAM_BATCH), "--prob_threshold", "0", "--save_test_images",
             "--visualize_gradcam", "--save_gradcam_images", "--tensorboard", "--device", DEVICE])
    except ModuleNotFoundError as e:
        if have_matplotlib or e.name != "matplotlib":
            raise
        stopped_at_plot = True
    torch.cuda.synchronize()
    timings["gradcam_cli_s"] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    samples = ImageFolderIndex(os.path.join(data, "test")).samples
    classes = ["fog", "rain", "snow", "sun"]
    want = [os.path.join(out, f"GradCAM_{classes[label]}", f"gradcam_{k // GRADCAM_BATCH}_"
                         f"{k % GRADCAM_BATCH}.png") for k, (_, label) in enumerate(samples)]
    shapes = [None if not os.path.exists(p) else cv2.imread(p).shape for p in want]
    tb_dir = os.path.join(out, "TensorBoard")
    events = sorted(os.listdir(tb_dir)) if os.path.isdir(tb_dir) else []

    staged = np.stack([load_image_staged(p) for p, _ in samples])
    labels = [label for _, label in samples]
    card = gradcam_moco(model, staged, labels, truncate=F1_TRUNCATE).cpu().numpy()
    cpu = gradcam_moco(seeded, staged, labels, truncate=F1_TRUNCATE).numpy()
    raw = _cam_for_moco(seeded, eval_preprocess(torch.from_numpy(staged)),
                        torch.tensor(labels), F1_TRUNCATE).numpy()
    real = [k for k in range(len(samples)) if _real_cam(raw[k])]
    zero = [k for k in range(len(samples)) if not raw[k].any()]
    gap = float(np.abs(card[real] - cpu[real]).max()) if real else float("nan")
    zero_gap = float(np.abs(card[zero]).max()) if zero else 0.0
    ms = []
    for k in range(GRADCAM_TIMED + 1):  # the first call warms cuDNN's plans
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gradcam_moco(model, staged[k % len(samples)][None], [labels[k % len(samples)]],
                     truncate=F1_TRUNCATE)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    ms_per_cam = float(np.median(ms[1:]))
    print(f"[gradcam] CLI on {len(samples)} images (b{GRADCAM_BATCH}) in "
          f"{timings['gradcam_cli_s']:.2f} s; overlays {sum(x is not None for x in shapes)} of "
          f"{len(want)}, shapes {sorted(set(map(str, shapes)))}; card vs CPU CAMs max abs "
          f"{gap:.3e} over {len(real)} real CAMs (tol 1e-3; {len(zero)} all-zero ones, card max "
          f"{zero_gap:.3e}); {ms_per_cam:.3f} ms per CAM (b1, median of {GRADCAM_TIMED}, host "
          f"clock); TensorBoard writer present: {bool(events)}, event files {events}; "
          f"matplotlib "
          f"{'absent: the CLI stopped at confusion_matrix.png' if stopped_at_plot else 'present'}; "
          f"hand-written launches {launches}")
    timings["gradcam_ms_per_cam"] = ms_per_cam
    _require(os.path.exists(os.path.join(out, "metrics.txt"))
             and os.path.exists(os.path.join(out, "confusion_matrix.png")) != stopped_at_plot,
             f"metrics.txt, and confusion_matrix.png unless matplotlib is absent: "
             f"{sorted(os.listdir(out))}")
    _require(sum(len(os.listdir(os.path.join(out, c))) for c in classes) == len(samples),
             "one annotated PNG an image")
    _require(all(x == (224, 672, 3) for x in shapes), f"every overlay at 224x672x3: {shapes}")
    _require(len(real) >= len(samples) // 2, f"at least half the CAMs are real: {len(real)}")
    _require(gap <= 1e-3 and zero_gap <= 1e-3, f"card CAMs agree with the CPU: {gap}, {zero_gap}")
    _require(not any(launches.values()), f"family 1 launches no hand-written kernel: {launches}")
    return {"overlays": len(want), "real_cams": len(real), "max_abs_err": gap,
            "ms_per_cam": ms_per_cam, "ms_runs": ms[1:], "tensorboard_events": events,
            "stopped_at_plot": stopped_at_plot, "launches": launches}


def phase_content_style(kernels, model, seeded, tmp: str, timings: dict) -> dict:
    """Family 2's content+style loop at full width (truncate 8, --layers 8
    --style_layers all: a Gram at each of the four stages), b4, 224²,
    init "content", threshold 0, 20 iterations, f32 and bf16, through
    ``content_style_transfer_gram_attention`` on in-memory batches; exact
    launch counts (4 gram_fwd and 4 gram_bwd an iteration, and 4 gram_fwd
    for each of the style and content targets); the f32 loss falls; 2
    iterations on the card and on the CPU from the same content (2 images):
    the pixels' change within the CPU loop's own spread; then the family-2
    CLI once with --style_image on 4 images, 2 iterations."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main as cli
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        content_style_transfer_gram_attention,
        make_content_style_optimizer,
        make_extract_fn_gram_attention,
    )
    from heuristique_style_transfer_code_tpu_torch.tools.profile_main_path import _profile

    batches = _batches(CS_BATCH, CS_BATCH, seed=24)
    style_u8 = np.random.RandomState(25).randint(0, 256, (256, 256, 3)).astype(np.uint8)
    iters, grams = CS_ITERS, 4
    quiet = lambda msg: None  # noqa: E731
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        compute = None if dtype == torch.float32 else dtype
        kw = dict(layers=8, truncate_layer=8, style_layers="all", threshold=0.0,
                  compute_dtype=compute, log_fn=quiet)
        content_style_transfer_gram_attention(model, batches, style_u8,
                                              os.path.join(tmp, "cs_warm"), num_iterations=2, **kw)
        history = []
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = content_style_transfer_gram_attention(
            model, batches, style_u8, os.path.join(tmp, f"cs_{name}"), num_iterations=iters,
            history=history, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        want = {"gram_fwd": grams * (iters + 2), "gram_bwd": grams * iters, "pooled_gram_fwd": 0,
                "pooled_gram_bwd": 0, "instance_norm_fwd": 0, "instance_norm_bwd": 0}
        first, last = history[0][0].cpu().numpy(), history[0][-1].cpu().numpy()

        extract = make_extract_fn_gram_attention(model, 8, 8, compute, "all")
        images = eval_preprocess(torch.from_numpy(batches[0]["image"]).to(DEVICE))
        with torch.no_grad():
            style = [g[0].expand((CS_BATCH,) + tuple(g.shape[1:])) for g in extract(
                eval_preprocess(torch.from_numpy(style_u8)[None].to(DEVICE)))[1]]
            feats = extract(images)[0].float()
        prof = _profile(lambda: make_content_style_optimizer(extract, learning_rate=0.01,
                                                             num_iterations=5, threshold=0.0)(
            images, style, feats), 1)
        ips = CS_BATCH * iters / seconds
        busy = prof["device_busy_ms"] / 5
        print(f"[content_style] {name} b{CS_BATCH}: {iters} iterations in {seconds:.3f} s, "
              f"{ips:.2f} image-iterations/s; launches {launches}; losses it1 "
              f"{first.round(6).tolist()} -> it{iters} {last.round(6).tolist()}; device busy "
              f"{busy:.3f} ms an iteration, idle share {prof['idle_share']:.3f} over 5 profiled "
              f"iterations ({prof['window_ms']:.3f} ms; Gram kernels "
              f"{prof['gram_share_of_busy']:.4f} of busy)")
        timings[f"content_style_{name}_s"] = seconds
        out[name] = {"image_iterations_per_s": ips, "seconds": seconds, "launches": launches,
                     "first_losses": first.tolist(), "last_losses": last.tolist(),
                     "busy_ms_per_iteration": busy, "profile": prof}
        _require(launches == want, f"launches {want} for one batch of {iters} iterations: "
                 f"{launches}")
        _require(len(saved) == CS_BATCH and all(os.path.exists(p) for p in saved),
                 f"{CS_BATCH} PNGs written")
        _require(len(history) == 1 and len(history[0]) == iters, f"{iters} iterations")
        _require(bool(np.isfinite(first).all() and np.isfinite(last).all()),
                 f"finite losses: {first}, {last}")
        if compute is None:
            _require(bool((last < first).all()), f"every f32 loss fell: {first} -> {last}")

    # 2 iterations of 2 images, card vs CPU from the same content image
    cpu_extract = make_extract_fn_gram_attention(seeded, 8, 8, None, "all")
    x0 = eval_preprocess(torch.from_numpy(batches[0]["image"][:2]))
    nudged = x0 * (1 + F3_STYLE_NUDGE * torch.randn(x0.shape,
                                                    generator=torch.Generator().manual_seed(26)))
    moves = {}
    t_cpu = time.perf_counter()
    for side, fn, dev, start in (("card", make_extract_fn_gram_attention(model, 8, 8, None, "all"),
                                  DEVICE, x0),
                                 ("cpu", cpu_extract, "cpu", x0),
                                 ("cpu_nudged", cpu_extract, "cpu", nudged)):
        with torch.no_grad():
            tg = [g[0].expand((2,) + tuple(g.shape[1:])) for g in fn(
                eval_preprocess(torch.from_numpy(style_u8)[None].to(dev)))[1]]
            cf = fn(x0.to(dev))[0].float()
        final = make_content_style_optimizer(fn, learning_rate=0.01, num_iterations=2,
                                             threshold=0.0)(start.to(dev), tg, cf)[0]
        moves[side] = final.cpu() - start
    t_cpu = time.perf_counter() - t_cpu
    errs, spread = _rel_errs(moves["card"], moves["cpu"]), _rel_errs(moves["cpu_nudged"],
                                                                     moves["cpu"])
    print(f"[content_style] card vs CPU, 2 images x 2 iterations f32: pixel change (max, RMS) "
          f"{[round(e, 9) for e in errs]}; the CPU's own spread from content nudged by "
          f"{F3_STYLE_NUDGE}: {[round(e, 9) for e in spread]} (RMS tol max("
          f"{TOL_MODEL['float32'][1]}, 2x the spread's)); CPU loops {t_cpu:.1f} s")
    out["pixel_change_errs"], out["pixel_change_spread"] = errs, spread
    _require(errs[1] <= max(TOL_MODEL["float32"][1], 2 * spread[1]),
             f"card pixel change agrees with the CPU: {errs}, {spread}")

    # the CLI, once
    data = _image_folder(os.path.join(tmp, "cs_data"), 1, seed=27)
    cfg = os.path.join(tmp, "family2.json")
    style_path = os.path.join(tmp, "style.png")
    from PIL import Image

    Image.fromarray(style_u8).save(style_path)
    with open(cfg, "w") as f:
        json.dump({"batch_size": CS_BATCH, "truncate_layer": 8, "gram_matrix_size": POOL_S}, f)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli(["--data", data, "--config_path", cfg, "--model_path", os.path.join(tmp, "family2.npz"),
         "--mode", "style_transfer", "--save_dir", os.path.join(tmp, "cs_cli"), "--layers", "8",
         "--num_iterations", "2", "--threshold", "0", "--style_image", style_path,
         "--style_layers", "all", "--device", DEVICE])
    torch.cuda.synchronize()
    timings["content_style_cli_s"] = time.perf_counter() - t0
    cli_launches = kernels.launch_counts()
    pngs = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(tmp, "cs_cli")) for f in fs
            if f.startswith("content_style_")]
    shapes = sorted({str(Image.open(p).size) + Image.open(p).mode for p in pngs})
    print(f"[content_style] CLI --style_image on 4 images, 2 iterations: {len(pngs)} PNGs "
          f"{shapes} in {timings['content_style_cli_s']:.2f} s; launches {cli_launches}")
    _require(len(pngs) == 4 and shapes == ["(448, 224)RGBA"], f"4 RGBA PNGs: {pngs}, {shapes}")
    _require(cli_launches["gram_bwd"] == grams * 2 and cli_launches["gram_fwd"] == grams * 4,
             f"the CLI's launches: {cli_launches}")
    out["cli_launches"] = cli_launches
    out["launches"] = {k: out["float32"]["launches"][k] + out["bfloat16"]["launches"][k]
                       + cli_launches[k] for k in cli_launches}
    return out


def phase_content_style_serve(kernels, tmp: str) -> dict:
    """``serve_style`` in content+style mode: a 2-style gallery (``--style_image
    a=... --style_image b=...``), --style_layers all, 5 iterations, batch 4;
    GET /styles, then 8 concurrent raw POSTs (one-hot a, one-hot b and
    a:0.5,b:0.5); each one-hot answer against the service's own job
    program run in process on that image with the same style."""
    import numpy as np
    import torch
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

    cfg = os.path.join(tmp, "family2.json")  # written by phase_content_style
    paths = []
    rng = np.random.RandomState(28)
    for name in ("a", "b"):
        paths.append(os.path.join(tmp, f"gallery_{name}.png"))
        Image.fromarray(rng.randint(0, 256, (300, 400, 3)).astype(np.uint8)).save(paths[-1])
    t0 = time.perf_counter()
    srv, service, url = _serve(["--config_path", cfg, "--model_path",
                                os.path.join(tmp, "family2.npz"), "--style_image", f"a={paths[0]}",
                                "--style_image", f"b={paths[1]}", "--style_layers", "all",
                                "--num_iterations", str(CS_SERVE_ITERS), "--threshold", "0",
                                "--batch_size", str(CS_BATCH), "--port", "0", "--device", DEVICE])
    start_s = time.perf_counter() - t0
    images = rng.randint(0, 256, (CS_SERVE_REQUESTS, 224, 224, 3)).astype(np.uint8)
    styles = ["a", "b", "a:0.5,b:0.5"] * 3

    def post(k):
        req = urllib.request.Request(url + "/style", data=images[k].tobytes(), method="POST",
                                     headers={"X-Raw-Shape": "224,224,3", "X-Style": styles[k]})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), dict(r.headers)

    try:
        listed = json.loads(_get(url, "/styles")[1])
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CS_SERVE_REQUESTS) as pool:
            answers = list(pool.map(post, range(CS_SERVE_REQUESTS)))
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        stats = json.loads(_get(url, "/stats")[1])
    finally:
        _stop(srv, service)
    # cuDNN's backward sums in no fixed order, and Adam's first step is
    # lr·sign(g) for every pixel: one whose gradient is within f32 rounding
    # of zero may step the other way. So a one-hot answer is held to the
    # in-process job by 99.9% of values within one uint8 step and all
    # within 2·lr·iterations (normalised units; std <= 0.229) + 1 step.
    bound = int(np.ceil(2 * 0.01 * CS_SERVE_ITERS * 0.229 * 255)) + 1
    gaps, within = [], []
    for k in range(CS_SERVE_REQUESTS):
        if "," in styles[k]:
            continue
        w = np.zeros((CS_BATCH, 2), np.float32)
        w[:, "ab".index(styles[k])] = 1.0
        job = service._jobs_by_size[CS_BATCH](np.stack([images[k]] * CS_BATCH), w,
                                             np.zeros((CS_BATCH,), np.int32))[0]
        diff = np.abs(decode_png(answers[k][1]).astype(np.int16)
                      - job[0].cpu().numpy().astype(np.int16))
        gaps.append(int(diff.max()))
        within.append(float((diff <= 1).mean()))
    print(f"[content_style_serve] GET /styles {listed}; {CS_SERVE_REQUESTS} requests in "
          f"{seconds:.3f} s (start {start_s:.2f} s), X-Iterations "
          f"{[h.get('X-Iterations') for _, _, h in answers]}; stats {json.dumps(stats)}; "
          f"launches {launches}; one-hot answers vs the in-process job: max gaps {gaps} "
          f"uint8 steps (tol {bound}), share within one step {within} (tol 0.999)")
    _require(listed == {"styles": ["a", "b"]}, f"GET /styles lists the gallery: {listed}")
    _require(all(st == 200 and h.get("X-Iterations") == str(CS_SERVE_ITERS)
                 for st, _, h in answers), "every answer is 200 after the iterations asked for")
    _require(stats["jobs"] == CS_SERVE_REQUESTS, f"/stats counts the jobs: {stats}")
    _require(launches["gram_bwd"] == 4 * CS_SERVE_ITERS * stats["batches"],
             f"4 gram_bwd an iteration in each of {stats['batches']} batches: {launches}")
    _require(all(g <= bound for g in gaps) and min(within) >= 0.999,
             f"one-hot answers agree with the in-process job: {gaps}, {within}")
    return {"seconds": seconds, "stats": stats, "launches": launches, "one_hot_gaps": gaps,
            "one_hot_within_one_step": within}


def _train_grads(extract, net, images_u8, targets, style_w, compute):
    """One training step's loss and gradients (by parameter name), without
    the Adam update: the step's own loss through ``autograd.grad``."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.tasks.fast_style import _net_loss

    dev = next(net.parameters()).device
    images = eval_preprocess(torch.as_tensor(images_u8).to(dev), FST_CROP)
    w = None if style_w is None else torch.as_tensor(style_w).to(dev)
    loss = _net_loss(extract, net, images, [t.to(dev) for t in targets], (1.0, 1.0, 0.0),
                     compute, w)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in net.named_parameters()])
    return float(loss.detach()), {n: g.detach().cpu() for n, g in zip(names, grads)}


def _zero_gradient_bias(name: str) -> bool:
    """A net bias whose true gradient is zero: a conv bias in front of an
    instance norm (all but ``out``), and each residual block's second norm
    bias (no ReLU follows it; its per-channel constant reaches only convs
    whose norms remove it)."""
    return name.endswith(".bias") and (".in_b." in name or not (
        name.split(".")[-2].startswith("in") or name.startswith("out.")))


def _grads_vs_cpu(card, cpu, only=None):
    """(worst relative L2 error over the leaves with a true gradient, worst
    noise of the zero-gradient biases relative to the largest gradient,
    every card gradient finite)."""
    import torch

    largest = max(float(g.abs().max()) for g in cpu.values())
    worst, noise = 0.0, 0.0
    for name, g in cpu.items():
        if only is not None and not only(name):
            continue
        if _zero_gradient_bias(name):
            noise = max(noise, float(card[name].abs().max()) / largest,
                        float(g.abs().max()) / largest)
        else:
            worst = max(worst, float((card[name] - g).norm() / g.norm()))
    finite = all(bool(torch.isfinite(g).all()) for g in card.values())
    return worst, noise, finite


def _net_pair(seed: int, n_styles=None):
    """The classic net (width 32, n_res 5) seeded on the CPU, and the same
    weights on the card; a conditional net's tables perturbed per style."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import (
        InstanceNorm,
        transformer_net_init,
    )

    gen = torch.Generator().manual_seed(seed)
    cpu = transformer_net_init(gen, width=32, n_res=5, n_styles=n_styles, device="cpu")
    if n_styles:
        with torch.no_grad():
            for m in cpu.modules():
                if isinstance(m, InstanceNorm):
                    m.weight.add_(0.3 * torch.randn(m.weight.shape, generator=gen))
                    m.bias.add_(0.3 * torch.randn(m.bias.shape, generator=gen))
    card = transformer_net_init(None, width=32, n_res=5, n_styles=n_styles, device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def _train_cli(cli, args, preempt_after=None):
    """A train CLI's ``main(args)`` once; with ``preempt_after``, a real
    SIGTERM to this process at that batch boundary (through the CLI's own
    handler)."""
    import signal

    from heuristique_style_transfer_code_tpu_torch.train import preemption

    real = preemption.preemption_requested
    if preempt_after is not None:
        calls = {"n": 0}

        def requested():
            calls["n"] += 1
            if calls["n"] == preempt_after + 1:
                os.kill(os.getpid(), signal.SIGTERM)
                deadline = time.perf_counter() + 5.0
                while not real() and time.perf_counter() < deadline:
                    time.sleep(0.001)  # the handler runs between bytecodes
            return real()

        preemption.preemption_requested = requested
    previous = signal.getsignal(signal.SIGTERM)
    try:
        cli(args)
    finally:
        preemption.preemption_requested = real
        preemption.clear_preemption()
        signal.signal(signal.SIGTERM, previous)


def _tree_gap(path_a: str, path_b: str, init):
    """Two ``style_net.npz`` files from the same ``init`` net: the worst RMS
    gap per leaf over the leaves with a true gradient, and the farthest
    that a zero-gradient bias moved from ``init`` on either side."""
    import numpy as np

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz

    a, b = _flatten(load_pytree_npz(path_a)), _flatten(load_pytree_npz(path_b))
    start = _flatten(to_jax_tree(init))
    rms, bias = 0.0, 0.0
    for key in a:
        x, y = np.asarray(a[key], np.float64), np.asarray(b[key], np.float64)
        if _zero_gradient_bias(key.replace("/", ".")):
            bias = max(bias, float(np.abs(x - start[key]).max()),
                       float(np.abs(y - start[key]).max()))
        else:
            rms = max(rms, float(np.sqrt(np.mean((x - y) ** 2))))
    return rms, bias


def phase_fast_style_train(kernels, model, seeded, tmp: str, timings: dict) -> dict:
    """Fast-style training at full width: the classic net (width 32, n_res
    5), crop 224, b16, the family-2 encoder at truncate 8 with
    --style_layers all (a Gram at each of the four stages), seeded weights.

    (a) f32 and bf16: ``train_fast_style`` over one in-memory batch 8
    times, exact launches (a step: 4 gram_fwd and 4 gram_bwd on the
    stylised pass, 15 instance_norm_fwd and 15 instance_norm_bwd; 4
    gram_fwd for the style targets), the last loss under a tenth of the
    first, no encoder parameter with a gradient; one step's loss and
    gradients on the card against the CPU (f32). (b) A 3-style conditional
    net through ``train_multi_style``, one step, launches, and its
    gradients (the affine tables apart) against the CPU. (c) The CLI on 8
    PNGs, b4, 2 epochs, a single style and a two-style gallery: two
    uninterrupted runs (their gap is the card's own spread), then
    ``--resume --checkpoint_every 1`` stopped by a SIGTERM after 3 batches
    and resumed to the end (the gallery with ``--async_checkpoint``), held
    to the first uninterrupted run; then
    ``serve_style --net`` on the gallery's net, one POST per style. (d)
    Steps/s and images/s (host clock), device busy and idle share over 3
    profiled steps, and the peak memory, f32 and bf16."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import transformer_net_init
    from heuristique_style_transfer_code_tpu_torch.tasks.fast_style import (
        _style_onehot,
        encode_style_gram_stacks,
        encode_style_grams,
        make_fast_style_train_step,
        train_fast_style,
        train_multi_style,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_extract_fn_gram_attention,
    )
    from heuristique_style_transfer_code_tpu_torch.tools.profile_main_path import _profile
    from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

    rng = np.random.RandomState(40)
    ab = [rng.randint(0, 256, (FST_BATCH, 256, 256, 3)).astype(np.uint8) for _ in range(2)]
    batches = [{"image": ab[0]}] * FST_STEPS  # one batch, so that the losses compare
    style_u8 = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    gallery = [rng.randint(0, 256, (256, 256, 3)).astype(np.uint8) for _ in range(3)]
    quiet = lambda msg: None  # noqa: E731
    out, launches_all = {}, {}

    def add(launches):
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v

    cpu_extract = make_extract_fn_gram_attention(seeded, 8, None, None, "all")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        compute = None if dtype == torch.float32 else dtype
        extract = make_extract_fn_gram_attention(model, 8, None, compute, "all")
        net, net_cpu = _net_pair(41)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, history = train_fast_style(net, extract, batches, style_u8, epochs=1, crop=FST_CROP,
                                      compute_dtype=compute, log_every=1, log_fn=quiet)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        add(launches)
        steps = FST_STEPS
        want = {"gram_fwd": 4 * steps + 4, "gram_bwd": 4 * steps, "pooled_gram_fwd": 0,
                "pooled_gram_bwd": 0, "instance_norm_fwd": NORMS_PER_FORWARD * steps,
                "instance_norm_bwd": NORMS_PER_FORWARD * steps}
        losses = history[:steps]
        print(f"[fast_style_train] {name} b{FST_BATCH}: {steps} steps of train_fast_style in "
              f"{seconds:.3f} s (first step's build and warm-up included); launches {launches}; "
              f"losses {[round(v, 4) for v in losses]}")
        _require(launches == want, f"launches {want} for {steps} steps: {launches}")
        _require(len(losses) == steps and all(np.isfinite(losses)), f"finite losses: {history}")
        # Adam's first steps at lr 1e-3 move every weight of the net by
        # about lr at once, so the loss need not fall at every step
        _require(losses[-1] < 0.1 * losses[0], f"the loss falls a tenfold over the steps: {losses}")
        _require(all(p.grad is None for p in model.parameters())
                 and not any(p.requires_grad for p in model.encoder.parameters()),
                 "the encoder is frozen: no parameter requires or holds a gradient")
        # one step on the card and on the CPU from the same weights (f32)
        row = {"seconds": seconds, "launches": launches, "losses": losses}
        if compute is None:
            targets = encode_style_grams(extract, style_u8, FST_CROP, DEVICE)
            t0 = time.perf_counter()
            cpu_targets = encode_style_grams(cpu_extract, style_u8, FST_CROP, "cpu")
            rows = ab[0][:FST_CPU_ROWS]
            loss_cpu, g_cpu = _train_grads(cpu_extract, net_cpu, rows, cpu_targets, None, None)
            # the CPU's own spread: the same step from weights nudged by
            # FST_NUDGE, about the card's distance from the CPU in the loss
            gen = torch.Generator().manual_seed(46)
            with torch.no_grad():
                for p in net_cpu.parameters():
                    p.mul_(1 + FST_NUDGE * torch.randn(p.shape, generator=gen))
            _, g_nudged = _train_grads(cpu_extract, net_cpu, rows, cpu_targets, None, None)
            t_cpu = time.perf_counter() - t0
            spread = _grads_vs_cpu(g_nudged, g_cpu)[0]
            tol_grad = max(FST_TOL_GRAD, 2 * spread)
            card, _ = _net_pair(41)
            loss_card, g_card = _train_grads(extract, card, rows, targets, None, None)
            worst, noise, finite = _grads_vs_cpu(g_card, g_cpu)
            rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
            print(f"[fast_style_train] one f32 step, card vs CPU ({t_cpu:.1f} s on the CPU): "
                  f"loss {loss_card:.6f} vs {loss_cpu:.6f} (rel {rel:.2e}, tol {FST_TOL_LOSS}); "
                  f"gradients worst relative L2 {worst:.2e} (tol max({FST_TOL_GRAD}, 2x the "
                  f"CPU's own spread {spread:.2e} from weights nudged by {FST_NUDGE})); the "
                  f"zero-gradient biases' noise {noise:.2e} of the largest gradient "
                  f"(tol {FST_TOL_NOISE}); all finite {finite}")
            row.update(loss_card=loss_card, loss_cpu=loss_cpu, grad_worst_rel_l2=worst,
                       grad_cpu_spread=spread, bias_noise=noise)
            _require(finite and rel <= FST_TOL_LOSS and worst <= tol_grad
                     and noise <= FST_TOL_NOISE, "the card's step agrees with the CPU's")
        # (d) the step alone: host clock, profile, peak memory
        init, step = make_fast_style_train_step(extract, crop=FST_CROP, compute_dtype=compute)
        opt = init(net)
        targets = encode_style_grams(extract, style_u8, FST_CROP, DEVICE)
        step(net, opt, ab[0], targets)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(FST_TIMED):
            step(net, opt, ab[i % 2], targets)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FST_TIMED
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = _profile(lambda: step(net, opt, ab[0], targets), 3)
        busy = prof["device_busy_ms"] / 3
        print(f"[fast_style_train] {name} b{FST_BATCH} step: {ms:.3f} ms (host clock, "
              f"{FST_TIMED} steps), {1e3 / ms:.2f} steps/s, {FST_BATCH * 1e3 / ms:.1f} images/s; "
              f"device busy {busy:.3f} ms a step, idle share {prof['idle_share']:.3f} over 3 "
              f"profiled steps; Gram kernels {prof['gram_share_of_busy']:.4f} and instance-norm "
              f"kernels {prof['instance_norm_share_of_busy']:.4f} of busy; peak memory "
              f"{peak:.2f} GiB")
        row.update(step_ms=ms, steps_per_s=1e3 / ms, images_per_s=FST_BATCH * 1e3 / ms,
                   busy_ms_per_step=busy, peak_gib=peak, profile=prof)
        out[name] = row
        timings[f"fast_style_train_{name}_step_ms"] = ms
        del net, net_cpu, opt

    # (b) a 3-style conditional net, one step of train_multi_style, f32
    extract = make_extract_fn_gram_attention(model, 8, None, None, "all")
    net, net_cpu = _net_pair(42, n_styles=3)
    kernels.reset_launch_counts()
    _, history = train_multi_style(net, extract, batches[:1], gallery, epochs=1, crop=FST_CROP,
                                   seed=0, log_fn=quiet)
    launches = kernels.launch_counts()
    add(launches)
    w = _style_onehot(0, 0, FST_BATCH, 3, "balanced")
    stacks = encode_style_gram_stacks(extract, gallery, FST_CROP, DEVICE)
    cpu_stacks = encode_style_gram_stacks(cpu_extract, gallery, FST_CROP, "cpu")
    card, _ = _net_pair(42, n_styles=3)
    targets = [torch.einsum("bk,k...->b...", torch.as_tensor(w).to(DEVICE), s) for s in stacks]
    cpu_targets = [torch.einsum("bk,k...->b...", torch.as_tensor(w), s) for s in cpu_stacks]
    loss_card, g_card = _train_grads(extract, card, ab[0], targets, w, None)
    loss_cpu, g_cpu = _train_grads(cpu_extract, net_cpu, ab[0], cpu_targets, w, None)
    tables = lambda n: n.split(".")[-2].startswith("in")  # noqa: E731
    t_worst, t_noise, finite = _grads_vs_cpu(g_card, g_cpu, tables)
    worst, noise, _ = _grads_vs_cpu(g_card, g_cpu)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"[fast_style_train] 3-style conditional net, one step: launches {launches}; loss "
          f"{history[0]:.6f}; card vs CPU loss rel {rel:.2e}, affine tables' gradients worst "
          f"relative L2 {t_worst:.2e} (in_b noise {t_noise:.2e}), all gradients {worst:.2e} "
          f"(tol {tol_grad:.2e}, as the single-style step's), finite {finite}")
    _require(launches == {"gram_fwd": 4 + 4, "gram_bwd": 4, "pooled_gram_fwd": 0,
                          "pooled_gram_bwd": 0, "instance_norm_fwd": NORMS_PER_FORWARD,
                          "instance_norm_bwd": NORMS_PER_FORWARD},
             f"one conditional step's launches (and 4 gram_fwd for the stacks): {launches}")
    _require(finite and rel <= FST_TOL_LOSS and max(t_worst, worst) <= tol_grad
             and max(noise, t_noise) <= FST_TOL_NOISE,
             "the conditional step's gradients agree with the CPU's")
    out["conditional"] = {"launches": launches, "loss": history[0], "loss_rel": rel,
                          "tables_grad_worst_rel_l2": t_worst, "grad_worst_rel_l2": worst}
    del net, net_cpu, card

    # (c) the CLI: single style and a 2-style gallery, preempted and resumed
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch.cli.train_style_net import main as style_cli

    data = _image_folder(os.path.join(tmp, "fst_data"), 2, seed=43)
    paths = []
    for i, im in enumerate(gallery[:2]):
        paths.append(os.path.join(tmp, f"fst_style_{i}.png"))
        Image.fromarray(im).save(paths[-1])
    base = ["--data", data, "--config_path", os.path.join(tmp, "family2.json"), "--model_path",
            os.path.join(tmp, "family2.npz"), "--epochs", "2", "--batch_size", str(FST_CLI_BATCH),
            "--crop", str(FST_CROP), "--log_every", "1", "--device", DEVICE]
    cli = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for kind, styles in (("single", ["--style_image", paths[0]]),
                         ("gallery", ["--style_image", f"a={paths[0]}", "--style_image",
                                      f"b={paths[1]}"])):
        a, a2, b = (os.path.join(tmp, f"fst_{kind}_{run}") for run in ("a", "a2", "b"))
        _train_cli(style_cli, base + styles + ["--save_dir", a])
        _train_cli(style_cli, base + styles + ["--save_dir", a2])  # the card's own spread
        resume = ["--save_dir", b, "--resume", "--checkpoint_every", "1"]
        if kind == "gallery":
            resume.append("--async_checkpoint")
        _train_cli(style_cli, base + styles + resume, preempt_after=3)
        stopped = (not os.path.exists(os.path.join(b, "style_net.npz"))
                   and os.path.exists(os.path.join(b, "_inprogress_style_net.npz")))
        _train_cli(style_cli, base + styles + resume)
        init = transformer_net_init(torch.Generator().manual_seed(0), width=32, n_res=5,
                                    n_styles=2 if kind == "gallery" else None, device="cpu")
        gaps = {}
        for name, d in (("spread", a2), ("resumed", b)):
            rms, bias = _tree_gap(os.path.join(a, "style_net.npz"),
                                  os.path.join(d, "style_net.npz"), init)
            finals = []
            for run in (a, d):
                with open(os.path.join(run, "style_net_hyperparameters.json")) as f:
                    finals.append(json.load(f)["final_loss"])
            gaps[name] = (abs(finals[1] - finals[0]) / abs(finals[0]), rms, bias, finals[1])
        steps = 2 * 8 // FST_CLI_BATCH
        tol_loss = max(FST_TOL_RESUME_LOSS, 2 * gaps["spread"][0])
        tol_rms = max(FST_TOL_RESUME * steps * 1e-3, 2 * gaps["spread"][1])
        loss_rel, rms, bias, final = gaps["resumed"]
        print(f"[fast_style_train] CLI {kind}: preempted after 3 batches with the in-progress "
              f"file on disk {stopped}; resumed vs uninterrupted: final loss {final:.6f} (rel "
              f"{loss_rel:.2e}, tol {tol_loss:.2e}), parameters' worst RMS gap {rms:.3e} (tol "
              f"{tol_rms:.2e}), zero-gradient biases' largest move from the init {bias:.3e} "
              f"(tol {steps * 1e-3 * 1.01:.3e}: Adam's steps on rounding noise, at most 4.012 · "
              f"lr in 4 steps); two uninterrupted runs: loss rel {gaps['spread'][0]:.2e}, RMS "
              f"gap {gaps['spread'][1]:.3e}. Tolerances: max({FST_TOL_RESUME_LOSS}, 2x the "
              f"spread) and max(0.25 · steps · lr, 2x the spread). Not bit-equal on the card: "
              f"the reflect pads' backward accumulates with atomics, in no fixed order")
        cli[kind] = {"stopped": stopped, "resumed": gaps["resumed"], "spread": gaps["spread"]}
        _require(stopped and loss_rel <= tol_loss and rms <= tol_rms
                 and max(bias, gaps["spread"][2]) <= steps * 1e-3 * 1.01,
                 f"the resumed {kind} fit agrees with the uninterrupted one")
    timings["fast_style_train_cli_s"] = time.perf_counter() - t0
    cli_launches = kernels.launch_counts()
    add(cli_launches)
    net_path = os.path.join(tmp, "fst_gallery_b", "style_net.npz")
    srv, service, url = _serve(["--net", net_path, "--batch_size", "1", "--port", "0",
                                "--device", DEVICE])
    try:
        img = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
        answers = []
        for style in ("a", "b"):
            req = urllib.request.Request(url + "/style", data=img.tobytes(), method="POST",
                                         headers={"X-Raw-Shape": "224,224,3", "X-Style": style})
            with urllib.request.urlopen(req, timeout=600) as r:
                answers.append((r.status, decode_png(r.read())))
        listed = json.loads(_get(url, "/styles")[1])
    finally:
        _stop(srv, service)
    print(f"[fast_style_train] 8 CLI runs in {timings['fast_style_train_cli_s']:.1f} s, launches "
          f"{cli_launches}; serve_style --net on the gallery's net: /styles {listed}, answers "
          f"{[(st, a.shape) for st, a in answers]}")
    _require(listed == {"styles": ["a", "b"]}
             and all(st == 200 and a.shape == (FST_CROP, FST_CROP, 3) for st, a in answers),
             "serve_style --net serves the trained gallery")
    out["cli"] = cli
    out["launches"] = launches_all
    return out


def _npz_differ(path_a: str, path_b: str) -> list:
    """The keys of the leaves in which two checkpoints differ in any bit."""
    import numpy as np

    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz

    a, b = _flatten(load_pytree_npz(path_a)), _flatten(load_pytree_npz(path_b))
    _require(a.keys() == b.keys(), f"{path_a} and {path_b} hold the same leaves")
    return [k for k in a if not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))]


def phase_family2_train(kernels, tmp: str, timings: dict) -> dict:
    """Family-2 training at full width: truncate 7, S 7, b32, 224² crops,
    4 classes, seeded weights.

    (a) One step's launches through ``setup_gram_attention``'s train step:
    3 pooled_gram_fwd and 3 pooled_gram_bwd (one a stage, layer1..layer3),
    and with the encoder frozen (``--freeze_layers``) 3 and 0. (b) One f32
    step on the card against the same step on the CPU in float64 from the
    same weights and batch (one pad entry), by ``_step_vs_cpu``. (c) The
    CLI (``cli/train_gram_attention.py``) on 96 PNGs, 2 folds, 2 epochs,
    without ``--freeze_layers``: exact launches, the reference's artifact
    files; then with ``--resume --async_checkpoint`` stopped by a real
    SIGTERM after 3 batches and resumed, equal to the first run bit for
    bit, both with cuDNN's deterministic algorithms;
    ``best_global_model.npz`` classifies in the port's
    ``test_gram_attention`` CLI. (d) The b32 step alone, f32 and bf16:
    images/s on the host clock over F2T_TIMED steps (staged uint8 to the
    SGD update), device busy ms and idle share over 3 profiled steps, the
    hand-written kernels' share of busy, the host's own time by event (ops
    and CUDA runtime calls, under the profiler), and the peak memory."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main as test_cli
    from heuristique_style_transfer_code_tpu_torch.cli.train_gram_attention import main as train_cli
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tools.profile_main_path import _profile
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention

    cfg = GramAttentionConfig(batch_size=F2T_BATCH, lr=F2T_LR, truncate_layer=F2T_TRUNCATE,
                              gram_matrix_size=F2T_S, seed=0)
    combos = [(None, None)]
    rng = np.random.RandomState(70)
    u8 = [rng.randint(0, 256, (F2T_BATCH, 256, 256, 3)).astype(np.uint8) for _ in range(2)]
    labels = [rng.randint(0, 4, (F2T_BATCH,)).astype(np.int32) for _ in range(2)]
    labels[0][-1] = -1  # one pad entry, as the loader's short batch carries
    stages = F2T_TRUNCATE - 4  # a pooled Gram at each executed stage
    out = {}

    # (a) launches a step
    step_launches = {}
    for freeze in (False, True):
        setup = setup_gram_attention(cfg, 4, combos, freeze_encoder=freeze, device=DEVICE)
        model, opt = setup.init(torch.Generator().manual_seed(71))
        setup.train_step(model, opt, u8[0], labels[0])  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        setup.train_step(model, opt, u8[1], labels[1])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = {k: 0 for k in launches}
        want.update(pooled_gram_fwd=stages, pooled_gram_bwd=0 if freeze else stages)
        step_launches["frozen" if freeze else "trainable"] = launches
        _require(launches == want, f"one step's launches (freeze={freeze}): {launches}")
        del model, opt, setup
    print(f"[family2_train] one b{F2T_BATCH} step's launches: {step_launches}")
    out["step_launches"] = step_launches

    # (b) one f32 step, card vs CPU
    def make_model(device):
        return gram_attention_init(torch.Generator().manual_seed(72), F2T_TRUNCATE, 4, F2T_S,
                                   device=device).train()

    def forward(model, images):
        return gram_attention_apply(model, images, F2T_TRUNCATE, F2T_S, 4)[1]

    out["card_vs_cpu"] = _step_vs_cpu("family2_train", make_model, forward,
                                      make_augment_fn(combos), u8[0], labels[0])

    # (c) the CLI: artifacts, launches, preemption and resume
    data = _image_folder(os.path.join(tmp, "f2t_data"), F2T_PER_CLASS, seed=74, split="train")
    _image_folder(data, 2, seed=75, split="test")
    cfg_path = os.path.join(tmp, "f2t.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    base = ["--data", data, "--config_path", cfg_path, "--k_folds", "2", "--epochs", "2",
            "--device", DEVICE]
    a = os.path.join(tmp, "f2t_a")
    with _deterministic_cudnn():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _train_cli(train_cli, base + ["--save_dir", a])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = kernels.launch_counts()
        resume = _resume_vs_uninterrupted("family2_train", train_cli, base, tmp, "f2t",
                                          ["best_model_fold_0.npz", "best_model_fold_1.npz"],
                                          ["--async_checkpoint"])
    # 2 folds x 2 epochs x 2 steps and 2 folds x 2 validation batches, a
    # pooled Gram a stage each
    want = {k: 0 for k in cli_launches}
    want.update(pooled_gram_fwd=(8 + 4) * stages, pooled_gram_bwd=8 * stages)
    artifacts = ["best_performance_fold_0.json", "best_performance_fold_1.json",
                 "best_hyperparameters_fold_0.json", "best_hyperparameters_fold_1.json",
                 "best_model_results.json", "best_global_model.npz",
                 "best_global_model_hyperparameters.json", "best_model_fold_0.npz",
                 "best_model_fold_1.npz", "fold_0_performance.json", "fold_1_performance.json",
                 "training_info.json", "events.jsonl"]
    missing = [n for n in artifacts if not os.path.exists(os.path.join(a, n))]
    print(f"[family2_train] CLI, 2 folds x 2 epochs at b{F2T_BATCH}: {cli_s:.1f} s, launches "
          f"{cli_launches}; artifacts missing: {missing}")
    _require(cli_launches == want, f"the CLI's launches {want}: {cli_launches}")
    _require(not missing, f"the reference's artifact set: missing {missing}")
    ev = os.path.join(tmp, "f2t_eval")
    test_cli(["--data", data, "--config_path", cfg_path, "--model_path",
              os.path.join(a, "best_global_model.npz"), "--mode", "classification",
              "--save_dir", ev, "--device", DEVICE])
    with open(os.path.join(ev, "classification_results.json")) as f:
        classified = json.load(f)
    print(f"[family2_train] best_global_model.npz in test_gram_attention: {classified}")
    _require(all(np.isfinite(v) for v in classified.values()),
             "the trained checkpoint classifies in the port's family-2 CLI")
    timings["family2_train_cli_s"] = cli_s
    out["cli"] = {"seconds": cli_s, "launches": cli_launches, **resume,
                  "classified": classified}

    # (d) the step alone: host clock, profile, peak memory
    for dtype in (None, torch.bfloat16):
        name = "float32" if dtype is None else "bfloat16"
        setup = setup_gram_attention(cfg, 4, combos, compute_dtype=dtype, device=DEVICE)
        model, opt = setup.init(torch.Generator().manual_seed(76))
        setup.train_step(model, opt, u8[0], labels[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(F2T_TIMED):
            setup.train_step(model, opt, u8[i % 2], labels[i % 2])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / F2T_TIMED
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = _profile(lambda: setup.train_step(model, opt, u8[0], labels[0]), 3)
        busy = prof["device_busy_ms"] / 3
        host = [(k["name"][:32], round(k["ms"] / 3, 3), round(k["count"] / 3))
                for k in prof["top_host_events"][:8]]
        print(f"[family2_train] {name} b{F2T_BATCH} step: {ms:.3f} ms (host clock, {F2T_TIMED} "
              f"steps, staged uint8 to the SGD update), {F2T_BATCH * 1e3 / ms:.1f} images/s; "
              f"device busy {busy:.3f} ms a step, idle share {prof['idle_share']:.3f} over 3 "
              f"profiled steps; hand-written kernels {prof['gram_share_of_busy']:.4f} of busy; "
              f"peak memory {peak:.2f} GiB; top kernels "
              f"{[(k['name'][:40], round(k['ms'] / 3, 3)) for k in prof['top_kernels'][:5]]}; "
              f"host self time {prof['host_self_ms'] / 3:.2f} ms a step (under the profiler), "
              f"top host events (ms, count a step) {host}")
        out[name] = {"step_ms": ms, "images_per_s": F2T_BATCH * 1e3 / ms,
                     "busy_ms_per_step": busy, "idle_share": prof["idle_share"],
                     "peak_gib": peak, "profile": prof}
        timings[f"family2_train_{name}_step_ms"] = ms
        del model, opt, setup
    out["launches"] = cli_launches
    return out


def _step_grads(model, forward, augment, u8, labels, combos=None, draws=None):
    """One train step's loss, its gradients (by parameter name, on the
    host) and the running statistics after its forward, without the SGD
    update: the step's own augmentation (its output cast to the model's
    dtype), train-mode forward and masked loss."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.train.train_loop import masked_cross_entropy

    first = next(model.parameters())
    images = augment(torch.as_tensor(u8).to(first.device), combos, draws).to(first.dtype)
    loss = masked_cross_entropy(forward(model, images), torch.as_tensor(labels).to(first.device))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(loss.detach()), {n: g.detach().cpu() for (n, _), g in zip(named, grads)}, stats


def _step_vs_cpu(tag: str, make_model, forward, augment, u8, labels, combos=None, draws=None,
                 zero_grad=lambda name: False, step_grads=None) -> dict:
    """One f32 train step on the card against the same step on the CPU in
    float64 from the same weights, batch and draws: the loss; every
    gradient leaf by relative L2 within max(F2T_TOL_GRAD, twice the CPU's
    f32 step's own error on that leaf); a gradient whose true value is 0
    (``zero_grad``) by its largest entry against the largest gradient entry
    (FST_TOL_NOISE); the running statistics after the forward.
    ``step_grads`` (default ``_step_grads``, same arguments and results)
    takes the step another way: ``_mixed_step``'s. Both sides take
    CPU_CHECK_ROWS rows of the batch, its last (the pad entry where it has
    one) among them."""
    import numpy as np
    import torch

    if len(labels) > CPU_CHECK_ROWS:
        rows = np.r_[0:CPU_CHECK_ROWS - 1, len(labels) - 1]
        u8, labels = u8[rows], labels[rows]
        combos = combos[rows] if combos is not None else None
        draws = draws[rows] if draws is not None else None
    t0 = time.perf_counter()
    card = make_model(DEVICE)
    ref, f32 = make_model("cpu"), make_model("cpu")
    ref.load_state_dict(card.state_dict())
    f32.load_state_dict(card.state_dict())
    ref.double()
    step_grads = step_grads or _step_grads
    loss_ref, g_ref, s_ref = step_grads(ref, forward, augment, u8, labels, combos, draws)
    _, g_f32, _ = step_grads(f32, forward, augment, u8, labels, combos, draws)
    t_cpu = time.perf_counter() - t0
    loss_card, g_card, s_card = step_grads(card, forward, augment, u8, labels, combos, draws)
    largest = max(float(g.abs().max()) for g in g_ref.values())
    real = [k for k in g_ref if not zero_grad(k)]

    def rel_l2(g, k):
        return float((g[k].double() - g_ref[k]).norm() / g_ref[k].norm())

    err = {k: rel_l2(g_card, k) for k in real}
    tol = {k: max(F2T_TOL_GRAD, 2 * rel_l2(g_f32, k)) for k in real}
    worst = max(real, key=lambda k: err[k] / tol[k])
    widest = max(real, key=tol.get)
    noise = max([float(g_card[k].abs().max()) / largest for k in g_ref if zero_grad(k)],
                default=0.0)
    stats = max([float((s_card[k].double() - s_ref[k]).abs().max() / s_ref[k].abs().max())
                 for k in s_ref], default=0.0)
    rel = abs(loss_card - loss_ref) / abs(loss_ref)
    finite = all(bool(torch.isfinite(g).all()) for g in g_card.values())
    print(f"[{tag}] one f32 step, card vs CPU in float64 ({t_cpu:.1f} s for the CPU's float64 "
          f"and f32 steps): loss {loss_card:.9f} vs {loss_ref:.9f} (rel {rel:.2e}, tol "
          f"{F2T_TOL_LOSS}); gradients over {len(real)} leaves: the worst against its tol "
          f"{err[worst]:.2e} at {worst} (tol {tol[worst]:.2e}), the largest error "
          f"{max(err.values()):.2e}; tol max({F2T_TOL_GRAD}, 2x the CPU's f32 error), above "
          f"{F2T_TOL_GRAD} at {sum(t > F2T_TOL_GRAD for t in tol.values())} leaves, widest "
          f"{tol[widest]:.2e} at {widest}; {len(g_ref) - len(real)} zero-gradient biases' noise "
          f"{noise:.2e} of the largest gradient (tol {FST_TOL_NOISE}); running statistics worst "
          f"{stats:.2e} of each leaf's largest (tol {F2T_TOL_STATS}); all finite {finite}")
    _require(finite and rel <= F2T_TOL_LOSS and err[worst] <= tol[worst]
             and noise <= FST_TOL_NOISE and stats <= F2T_TOL_STATS,
             f"the card's {tag} step agrees with the CPU's")
    return {"loss_card": loss_card, "loss_ref": loss_ref, "loss_rel": rel,
            "grad_worst_rel_l2": err[worst], "grad_worst_leaf": worst,
            "grad_worst_tol": tol[worst], "grad_largest_rel_l2": max(err.values()),
            "grad_widest_tol": tol[widest], "grad_widest_leaf": widest,
            "zero_grad_noise": noise, "stats_worst_rel": stats, "cpu_seconds": t_cpu}


def _timed_step(tag: str, name: str, step, batch: int, n: int) -> dict:
    """``step`` n times on the host clock (staged uint8 to the SGD update),
    then 3 profiled steps: images/s, busy, idle share, hand-written
    kernels' share, peak memory."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.tools.profile_main_path import _profile

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(n):
        step(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _profile(step, 3)
    busy = prof["device_busy_ms"] / 3
    kshare = (prof["gram_share_of_busy"] or 0.0) + (prof["instance_norm_share_of_busy"] or 0.0)
    print(f"[{tag}] {name} b{batch} step: {ms:.3f} ms (host clock, {n} steps, staged uint8 to "
          f"the SGD update), {batch * 1e3 / ms:.1f} images/s; device busy {busy:.3f} ms a step, "
          f"idle share {prof['idle_share']:.3f} over 3 profiled steps; hand-written kernels "
          f"{kshare:.4f} of busy; peak memory {peak:.2f} GiB; top kernels "
          f"{[(k['name'][:40], round(k['ms'] / 3, 3)) for k in prof['top_kernels'][:5]]}")
    return {"step_ms": ms, "images_per_s": batch * 1e3 / ms, "busy_ms_per_step": busy,
            "idle_share": prof["idle_share"], "kernel_share_of_busy": kshare, "peak_gib": peak,
            "profile": prof}


class _deterministic_cudnn:
    """cuDNN's deterministic algorithms inside the block: a train CLI's
    runs then give the same bits wherever every op of its step is
    deterministic, so a resumed run is held to the uninterrupted one's."""

    def __enter__(self):
        import torch

        self._was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.deterministic = self._was


def _resume_vs_uninterrupted(tag: str, train_cli, base: list, tmp: str, name: str,
                             fold_files: list, resume_extra=()) -> dict:
    """Against the CLI's uninterrupted run in ``<tmp>/<name>_a``: the CLI
    with --resume stopped by a real SIGTERM after 3 batches and resumed,
    under cuDNN's deterministic algorithms; every fold checkpoint and each
    fold's validation loss must equal the uninterrupted run's bit for
    bit."""
    from heuristique_style_transfer_code_tpu_torch.train.kfold import _INPROGRESS_STATE

    a, b = os.path.join(tmp, f"{name}_a"), os.path.join(tmp, f"{name}_b")
    resume = base + ["--save_dir", b, "--resume", *resume_extra]
    _train_cli(train_cli, resume, preempt_after=3)
    stopped = (not os.path.exists(os.path.join(b, "best_model_results.json"))
               and os.path.exists(os.path.join(b, _INPROGRESS_STATE)))
    _train_cli(train_cli, resume)
    differ = [f"{f}:{k}" for f in fold_files
              for k in _npz_differ(os.path.join(a, f), os.path.join(b, f))]
    losses = []
    for k in range(len(fold_files)):
        with open(os.path.join(a, f"fold_{k}_performance.json")) as f, \
                open(os.path.join(b, f"fold_{k}_performance.json")) as g:
            losses.append((json.load(f)["val_loss"], json.load(g)["val_loss"]))
    print(f"[{tag}] CLI {' '.join(['--resume', *resume_extra])}: preempted by a SIGTERM after 3 "
          f"batches with the in-progress file on disk {stopped}; resumed vs uninterrupted: "
          f"{len(differ)} fold checkpoint leaves differ {differ[:4]}, validation losses "
          f"(uninterrupted, resumed) {losses} (held bit for bit)")
    _require(stopped and not differ and all(x == y for x, y in losses),
             f"the resumed {tag} run equals the uninterrupted one")
    return {"stopped": stopped, "leaves_differ": differ, "val_losses": losses}


def phase_family1_train(kernels, tmp: str, timings: dict) -> dict:
    """Family-1 training at full width: truncate 8, dim 256, b32, 224²
    crops of 256² staged uint8, 4 classes, seeded weights, with the
    identity and all 25 (geometric, colour) combinations.

    (a) Each of the ten transforms on the card against the same code on
    the CPU with the same host-drawn parameters, and the 26-combination
    batch. (b) One augmented f32 step on the card against the CPU's in
    float64 from the same weights, batch (one pad entry) and draws. (c)
    The CLI (``cli/train_truncated_resnet50.py``) on 24 PNGs, 2 folds, 2
    epochs, ``--geom_aug --color_aug`` with 2 transforms each: the
    reference's artifacts, run once more for the resume check (a real
    SIGTERM), both with cuDNN's deterministic algorithms.
    (d) The b32 step alone, F1T_TIMED timed steps and 3 profiled ones, augmented
    in f32 and bf16, and with the identity combination in f32 (the
    augmentation's cost). No hand-written kernel launches anywhere here."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.train_truncated_resnet50 import (
        main as train_cli,
    )
    from heuristique_style_transfer_code_tpu_torch.config.schema import TruncatedResNetConfig
    from heuristique_style_transfer_code_tpu_torch.data import augment as aug
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply,
        truncated_resnet50_init,
    )
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_truncated_resnet50

    kernels.reset_launch_counts()
    combos = [(None, None)] + [(g, c) for g in aug.AVAILABLE_GEOM_TRANSFORMS
                               for c in aug.AVAILABLE_COLOR_TRANSFORMS]
    cfg = TruncatedResNetConfig(batch_size=F1T_BATCH, lr=F1T_LR, truncate_layer=F1_TRUNCATE,
                                dim=F1_DIM, seed=0)
    rng = np.random.RandomState(80)
    u8 = [rng.randint(0, 256, (F1T_BATCH, 256, 256, 3)).astype(np.uint8) for _ in range(2)]
    labels = [rng.randint(0, 4, (F1T_BATCH,)).astype(np.int32) for _ in range(2)]
    labels[0][-1] = -1  # one pad entry, as the loader's short batch carries
    ids = [np.arange(F1T_BATCH) % len(combos), (np.arange(F1T_BATCH) * 7) % len(combos)]
    draws = [aug.batch_draws((80, 0, 0, i), F1T_BATCH) for i in range(2)]
    out = {}

    # (a) the transforms, card vs CPU on the same parameters
    worst = {}
    cases = [(name, [(name, None)]) for name in aug.AVAILABLE_GEOM_TRANSFORMS]
    cases += [(name, [(None, name)]) for name in aug.AVAILABLE_COLOR_TRANSFORMS]
    cases += [("all 26 combinations", combos)]
    for name, cs in cases:
        fn = aug.make_augment_fn(cs)
        n = F1T_BATCH if len(cs) > 1 else min(8, F1T_BATCH)
        cid = ids[0][:n] if len(cs) > 1 else np.zeros(n, np.int64)
        card = fn(torch.as_tensor(u8[0][:n]).to(DEVICE), cid, draws[0][:n]).cpu()
        cpu = fn(torch.as_tensor(u8[0][:n]), cid, draws[0][:n])
        worst[name] = float((card - cpu).abs().max())
    print(f"[family1_train] augmentation, card vs CPU on the same draws, max |diff| of the "
          f"normalised output (tol {F1T_TOL_AUG}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    _require(all(v <= F1T_TOL_AUG for v in worst.values()),
             "each transform on the card agrees with the CPU")
    out["augment_card_vs_cpu"] = worst

    # (b) one augmented f32 step, card vs CPU
    def make_model(device):
        return truncated_resnet50_init(torch.Generator().manual_seed(81), F1_TRUNCATE,
                                       F1_CLASSES, F1_DIM, device=device).train()

    def forward(model, images):
        return combined_apply(model.moco, model.classifier, images, F1_TRUNCATE, train=True)

    out["card_vs_cpu"] = _step_vs_cpu("family1_train", make_model, forward,
                                      aug.make_augment_fn(combos), u8[0], labels[0], ids[0],
                                      draws[0])

    # (c) the CLI with augmentation: artifacts, then preemption and resume
    data = _image_folder(os.path.join(tmp, "f1t_data"), F1T_PER_CLASS, seed=82, split="train")
    cfg_path = os.path.join(tmp, "f1t.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    base = ["--data", data, "--config_path", cfg_path, "--k_folds", "2", "--epochs", "2",
            "--geom_aug", "--color_aug", "--num_geom_transforms", "2",
            "--num_color_transforms", "2", "--device", DEVICE]
    a = os.path.join(tmp, "f1t_a")
    with _deterministic_cudnn():
        t0 = time.perf_counter()
        _train_cli(train_cli, base + ["--save_dir", a])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        out["cli"] = {"seconds": cli_s, **_resume_vs_uninterrupted(
            "family1_train", train_cli, base, tmp, "f1t",
            ["best_model_fold_0.npz", "best_model_fold_1.npz"])}
    artifacts = ["best_model_results.json", "best_global_model.npz",
                 "best_global_model_hyperparameters.json", "best_model_fold_0.npz",
                 "best_model_fold_1.npz", "fold_0_performance.json", "fold_1_performance.json",
                 "training_info.json", "events.jsonl"]
    missing = [n for n in artifacts if not os.path.exists(os.path.join(a, n))]
    print(f"[family1_train] CLI, 2 folds x 2 epochs at b{F1T_BATCH}, 4 combinations: "
          f"{cli_s:.1f} s; artifacts missing: {missing}")
    _require(not missing, f"the reference's artifact set: missing {missing}")
    timings["family1_train_cli_s"] = cli_s

    # (d) the step alone
    for name, cs, dtype in (("float32", combos, None), ("bfloat16", combos, torch.bfloat16),
                            ("float32 identity", [(None, None)], None)):
        setup = setup_truncated_resnet50(cfg, F1_CLASSES, cs, compute_dtype=dtype,
                                         device=DEVICE)
        model, opt = setup.init(torch.Generator().manual_seed(83))
        step_ids = ids if len(cs) > 1 else [np.zeros(F1T_BATCH, np.int64)] * 2

        def step(i=0, setup=setup, model=model, opt=opt, step_ids=step_ids):
            setup.train_step(model, opt, u8[i % 2], labels[i % 2], step_ids[i % 2],
                             draws[i % 2])

        out[name] = _timed_step("family1_train", name, step, F1T_BATCH, F1T_TIMED)
        timings[f"family1_train_{name.replace(' ', '_')}_step_ms"] = out[name]["step_ms"]
        del model, opt, setup
    out["augment_cost_ms"] = out["float32"]["step_ms"] - out["float32 identity"]["step_ms"]
    launches = kernels.launch_counts()
    print(f"[family1_train] augmentation cost {out['augment_cost_ms']:.3f} ms a b{F1T_BATCH} "
          f"step (26 combinations against the identity, f32, host clock); hand-written kernel "
          f"launches in the whole phase: {launches}")
    _require(not any(launches.values()), f"family-1 training launches no hand-written kernel: "
             f"{launches}")
    out["launches"] = launches
    return out


def _f3_zero_grad(name: str) -> bool:
    """A train-variant conv bias that a norm follows: the norm removes any
    per-channel constant, so its true gradient is 0 (not the out conv's)."""
    return name.endswith("conv.bias") and "out_conv" not in name


def phase_family3_train(kernels, tmp: str, timings: dict) -> dict:
    """Family-3 training at the config defaults (patch sizes 10/70/150,
    ndf 64, 4 classes), b32, 224² crops, norm "batch" and norm "instance",
    f32 and bf16.

    (a) One step's launches: 13 instance_norm_fwd and 13 instance_norm_bwd
    under "instance" (every norm of the three discriminators), none under
    "batch". (b) One f32 step on the card against the CPU's in float64
    from the same weights and batch, under each norm. (c) The CLI
    (``cli/train_multi_patchgan.py``) on 32 PNGs, 2 folds, 2 epochs, norm
    "instance": exact launches and the reference's artifacts
    (``model_fold_<k>``, ``retrained_performance.json``,
    ``retrained_hyperparameters.json``). (d) The b32 step alone in each of
    the four settings: F3T_TIMED timed steps, 3 profiled."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.train_multi_patchgan import (
        main as train_cli,
    )
    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_apply,
        multiscale_init,
    )
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_multi_patchgan

    combos = [(None, None)]
    rng = np.random.RandomState(90)
    u8 = [rng.randint(0, 256, (F3T_BATCH, 256, 256, 3)).astype(np.uint8) for _ in range(2)]
    labels = [rng.randint(0, 4, (F3T_BATCH,)).astype(np.int32) for _ in range(2)]
    labels[0][-1] = -1
    cfgs = {norm: MultiPatchGANConfig(batch_size=F3T_BATCH, lr=F3T_LR, norm=norm, seed=0)
            for norm in ("batch", "instance")}
    out = {}

    # (a) launches a step
    step_launches = {}
    for norm, cfg in cfgs.items():
        setup = setup_multi_patchgan(cfg, 4, combos, device=DEVICE)
        model, opt = setup.init(torch.Generator().manual_seed(91))
        setup.train_step(model, opt, u8[0], labels[0])  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        setup.train_step(model, opt, u8[1], labels[1])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = {k: 0 for k in launches}
        if norm == "instance":
            want.update(instance_norm_fwd=F3_NORMS, instance_norm_bwd=F3_NORMS)
        step_launches[norm] = launches
        _require(launches == want, f"one family-3 step's launches under {norm}: {launches}")
        del model, opt, setup
    print(f"[family3_train] one b{F3T_BATCH} step's launches: {step_launches}")
    out["step_launches"] = step_launches

    # (b) one f32 step, card vs CPU, under each norm
    for norm, cfg in cfgs.items():
        def make_model(device, cfg=cfg):
            return multiscale_init(torch.Generator().manual_seed(92), cfg.patch_sizes,
                                   ndf=cfg.ndf, num_classes=4, norm=cfg.norm,
                                   device=device).train()

        def forward(model, images, norm=norm):
            return multiscale_apply(model, images, norm, train=True)

        out[f"card_vs_cpu_{norm}"] = _step_vs_cpu(f"family3_train {norm}", make_model, forward,
                                                  make_augment_fn(combos), u8[0], labels[0],
                                                  zero_grad=_f3_zero_grad)

    # (c) the CLI at norm "instance"
    data = _image_folder(os.path.join(tmp, "f3t_data"), F3T_PER_CLASS, seed=93, split="train")
    cfg_path = os.path.join(tmp, "f3t.json")
    with open(cfg_path, "w") as f:
        json.dump(cfgs["instance"].to_dict(), f)
    save = os.path.join(tmp, "f3t_a")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _train_cli(train_cli, ["--data", data, "--config_path", cfg_path, "--epochs", "2",
                           "--save_dir", save, "--device", DEVICE])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = kernels.launch_counts()
    # 2 folds x 2 epochs x 1 step (16 train images) and 2 folds x 1
    # validation batch, 13 norms each
    want = {k: 0 for k in cli_launches}
    want.update(instance_norm_fwd=(4 + 2) * F3_NORMS, instance_norm_bwd=4 * F3_NORMS)
    artifacts = ["model_fold_0.npz", "model_fold_1.npz", "retrained_performance.json",
                 "retrained_hyperparameters.json", "best_global_model.npz",
                 "best_model_results.json", "training_info.json"]
    missing = [n for n in artifacts if not os.path.exists(os.path.join(save, n))]
    with open(os.path.join(save, "retrained_performance.json")) as f:
        perf = json.load(f)
    print(f"[family3_train] CLI, 2 folds x 2 epochs at b{F3T_BATCH}, norm instance: {cli_s:.1f} "
          f"s, launches {cli_launches}; artifacts missing: {missing}; "
          f"retrained_performance.json: {perf}")
    _require(cli_launches == want, f"the CLI's launches {want}: {cli_launches}")
    _require(not missing and len(perf) == 2 and all(np.isfinite(r["val_loss"]) for r in perf),
             f"the reference's family-3 artifacts: missing {missing}")
    timings["family3_train_cli_s"] = cli_s
    out["cli"] = {"seconds": cli_s, "launches": cli_launches, "performance": perf}

    # (d) the step alone
    for norm, cfg in cfgs.items():
        for dtype in (None, torch.bfloat16):
            name = f"{norm} {'float32' if dtype is None else 'bfloat16'}"
            setup = setup_multi_patchgan(cfg, 4, combos, compute_dtype=dtype, device=DEVICE)
            model, opt = setup.init(torch.Generator().manual_seed(94))

            def step(i=0, setup=setup, model=model, opt=opt):
                setup.train_step(model, opt, u8[i % 2], labels[i % 2])

            out[name] = _timed_step("family3_train", name, step, F3T_BATCH, F3T_TIMED)
            timings[f"family3_train_{name.replace(' ', '_')}_step_ms"] = out[name]["step_ms"]
            del model, opt, setup
    out["launches"] = cli_launches
    return out


# ----------------------- remat, serving, dispatch, accumulation, profile


def _remat_recompute_checks(kernels) -> list:
    """Each hand-written Function inside a remat block (``core/remat.py``:
    non-reentrant checkpointing, whose recompute must save tensors of the
    forward's number, shapes and dtypes): the output and the input gradient
    against the same call without the block, bit for bit, and the launches
    (the recompute adds one forward)."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.core.remat import remat_call
    from heuristique_style_transfer_code_tpu_torch.ops.gram import (
        gram_matrix_nhwc,
        pooled_gram_nhwc,
    )
    from heuristique_style_transfer_code_tpu_torch.ops.norm import instance_norm

    fns = {"gram": gram_matrix_nhwc, "instance_norm": lambda x: instance_norm(x, relu=True)}
    rows = []
    for name, shape, s in REMAT_FN_CASES:
        fn = (lambda x, s=s: pooled_gram_nhwc(x, s)) if s is not None else fns[name]
        gen = torch.Generator(device=DEVICE).manual_seed(len(rows))
        x = torch.rand(shape, device=DEVICE, generator=gen)
        if name == "instance_norm":
            x = x * 2 - 1
        out = {}
        for remat in (False, True):
            xi = x.clone().requires_grad_(True)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            y = remat_call(fn, xi) if remat else fn(xi)
            w = torch.cos(torch.arange(y.numel(), device=DEVICE, dtype=torch.float32)
                          ).reshape(y.shape)
            (g,) = torch.autograd.grad((y.float() * w).sum(), xi)
            torch.cuda.synchronize()
            out[remat] = (y.detach(), g, kernels.launch_counts())
        (y0, g0, l0), (y1, g1, l1) = out[False], out[True]
        fwd = "instance_norm_fwd" if name == "instance_norm" else f"{name}_fwd"
        row = {"function": name, "shape": list(shape), "S": s,
               "output_equal": bool(torch.equal(y0, y1)), "grad_equal": bool(torch.equal(g0, g1)),
               "launches_plain": l0, "launches_remat": l1}
        rows.append(row)
        print(f"[remat] {name} {shape}{'' if s is None else f' S {s}'} in a remat block: output "
              f"equal {row['output_equal']}, input gradient equal {row['grad_equal']}; "
              f"launches plain {({k: v for k, v in l0.items() if v})}, remat "
              f"{({k: v for k, v in l1.items() if v})}")
        _require(row["output_equal"] and row["grad_equal"] and l1[fwd] == l0[fwd] + 1
                 and all(l1[k] == l0[k] for k in l0 if k != fwd),
                 f"{name} {shape} recomputes once under remat, bit for bit")
    return rows


def _remat_step_pair(tag: str, kernels, make_model, forward, augment, u8, labels,
                     zero_grad=lambda name: False) -> dict:
    """One f32 train step's loss, gradients and running statistics with and
    without remat from the same weights, under cuDNN's deterministic
    algorithms: the loss within 1e-6 relative, each gradient leaf by
    relative L2 within REMAT_TOL_GRAD (the zero-gradient biases by their
    largest entry against the largest gradient, FST_TOL_NOISE), the
    running statistics bit for bit (the recompute updates copies); the
    step's peak memory above the weights (``max_memory_allocated``) and its
    launches in each."""
    import torch

    res = {}
    with _deterministic_cudnn():
        for remat in (False, True):
            model = make_model(DEVICE)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            loss, grads, stats = _step_grads(model, lambda m, x, r=remat: forward(m, x, r),
                                             augment, u8, labels)
            torch.cuda.synchronize()
            res[remat] = {"loss": loss, "grads": grads, "stats": stats,
                          "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                          "launches": kernels.launch_counts()}
            del model
    plain, remat = res[False], res[True]
    largest = max(float(g.abs().max()) for g in plain["grads"].values())
    real = [k for k in plain["grads"] if not zero_grad(k)]
    err = {k: float((remat["grads"][k].double() - plain["grads"][k]).norm()
                    / plain["grads"][k].double().norm()) for k in real}
    worst = max(real, key=err.get)
    noise = max([float(remat["grads"][k].abs().max()) / largest
                 for k in plain["grads"] if zero_grad(k)], default=0.0)
    bit_grads = sum(torch.equal(remat["grads"][k], plain["grads"][k]) for k in plain["grads"])
    stats_equal = all(torch.equal(remat["stats"][k], plain["stats"][k]) for k in plain["stats"])
    rel = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
    out = {"loss_plain": plain["loss"], "loss_remat": remat["loss"], "loss_rel": rel,
           "grad_worst_rel_l2": err[worst], "grad_worst_leaf": worst,
           "grad_leaves_bit_equal": int(bit_grads), "grad_leaves": len(plain["grads"]),
           "zero_grad_noise": noise, "stats_bit_equal": stats_equal,
           "stats_leaves": len(plain["stats"]),
           "peak_gib_plain": plain["peak_gib"], "peak_gib_remat": remat["peak_gib"],
           "launches_plain": plain["launches"], "launches_remat": remat["launches"]}
    print(f"[remat] {tag} b{len(labels)} step, remat vs plain (cuDNN deterministic): loss "
          f"{remat['loss']:.9f} vs {plain['loss']:.9f} (rel {rel:.2e}); gradients: "
          f"{bit_grads}/{len(plain['grads'])} leaves bit-equal, worst {err[worst]:.2e} at "
          f"{worst} (tol {REMAT_TOL_GRAD}), zero-gradient noise {noise:.2e}; running statistics "
          f"({len(plain['stats'])} leaves) bit-equal {stats_equal}; peak memory above the "
          f"weights {plain['peak_gib']:.3f} GiB plain, {remat['peak_gib']:.3f} GiB remat; "
          f"launches plain {({k: v for k, v in plain['launches'].items() if v})}, remat "
          f"{({k: v for k, v in remat['launches'].items() if v})}")
    _require(rel <= 1e-6 and err[worst] <= REMAT_TOL_GRAD and noise <= FST_TOL_NOISE
             and stats_equal and remat["peak_gib"] < plain["peak_gib"],
             f"the {tag} remat step equals the plain one, with less memory")
    return out


def phase_remat(kernels, tmp: str, timings: dict) -> dict:
    """``--remat`` at full width: (a) each hand-written Function inside a
    remat block (``_remat_recompute_checks``); (b) one family-2 b32 step
    (truncate 7, S 7, 224² crops) and one family-3 b32 step (the config
    defaults, norm "instance") with and without remat from the same
    weights (``_remat_step_pair``): family 2's pooled Grams sit outside
    the blocks, so its launches are equal; family 3's strided units hold
    10 of its 13 norms, so the recompute adds 10 instance_norm_fwd; (c)
    the b32 steps with and without remat by ``_timed_step``: host clock,
    busy, idle share, peak memory."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.config.schema import (
        GramAttentionConfig,
        MultiPatchGANConfig,
    )
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_apply,
        multiscale_init,
    )
    from heuristique_style_transfer_code_tpu_torch.nn.patch_discriminator import (
        discriminator_layer_plan,
    )
    from heuristique_style_transfer_code_tpu_torch.train.factories import (
        setup_gram_attention,
        setup_multi_patchgan,
    )

    out = {"functions": _remat_recompute_checks(kernels)}
    rng = np.random.RandomState(170)
    u8 = rng.randint(0, 256, (F2T_BATCH, 256, 256, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, (F2T_BATCH,)).astype(np.int32)
    augment = make_augment_fn([(None, None)])
    f3cfg = MultiPatchGANConfig(batch_size=F3T_BATCH, lr=F3T_LR, norm="instance", seed=0)

    def f2_model(device):
        return gram_attention_init(torch.Generator().manual_seed(171), F2T_TRUNCATE, 4, F2T_S,
                                   device=device).train()

    def f2_forward(model, images, remat):
        return gram_attention_apply(model, images, F2T_TRUNCATE, F2T_S, 4, remat=remat)[1]

    def f3_model(device):
        return multiscale_init(torch.Generator().manual_seed(172), f3cfg.patch_sizes,
                               ndf=f3cfg.ndf, num_classes=4, norm="instance",
                               device=device).train()

    def f3_forward(model, images, remat):
        return multiscale_apply(model, images, "instance", train=True, remat=remat)

    out["family2"] = _remat_step_pair("family2", kernels, f2_model, f2_forward, augment, u8,
                                      labels)
    f2 = out["family2"]
    _require(f2["launches_remat"] == f2["launches_plain"],
             "family 2's pooled Grams launch as often under remat")
    out["family3_instance"] = _remat_step_pair("family3 instance", kernels, f3_model,
                                               f3_forward, augment, u8, labels,
                                               zero_grad=_f3_zero_grad)
    f3 = out["family3_instance"]
    strided = sum(len(discriminator_layer_plan(p, f3cfg.ndf)[0])
                  for p in f3cfg.patch_sizes.values())
    want = dict(f3["launches_plain"], instance_norm_fwd=F3_NORMS + strided)
    _require(f3["launches_plain"]["instance_norm_fwd"] == F3_NORMS and f3["launches_remat"] == want,
             f"family 3's recompute adds one instance_norm_fwd per strided unit ({strided})")

    for fam, make_setup in (("family2", lambda r: setup_gram_attention(
            GramAttentionConfig(batch_size=F2T_BATCH, lr=F2T_LR, truncate_layer=F2T_TRUNCATE,
                                gram_matrix_size=F2T_S), 4, [(None, None)], remat=r,
            device=DEVICE)), ("family3_instance", lambda r: setup_multi_patchgan(
                f3cfg, 4, [(None, None)], remat=r, device=DEVICE))):
        for remat in (False, True):
            name = "remat" if remat else "plain"
            setup = make_setup(remat)
            model, opt = setup.init(torch.Generator().manual_seed(173))
            out[fam][name] = _timed_step(f"remat {fam}", name, lambda i=0: setup.train_step(
                model, opt, u8, labels), F2T_BATCH, REMAT_TIMED)
            timings[f"remat_{fam}_{name}_step_ms"] = out[fam][name]["step_ms"]
            del model, opt, setup
    out["launches"] = f3["launches_remat"]
    return out


def phase_family3_serve(kernels, family3, tmp: str, timings: dict) -> dict:
    """``serve_style --family multi_patchgan`` over HTTP at 224², norm
    "instance" and "batch", in rgb and yuv420: F3S_REQUESTS POSTs each
    (b1, F3S_ITERS iterations, threshold 0), exact launches, every reply
    within one uint8 step of the service's texture job run again in process
    on the same canvas and job id (cuDNN deterministic; the gaps are
    printed, 0 where every kernel of the loop gives the same bits twice;
    the yuv420 reply is cv2's ``COLOR_YUV2RGB_I420`` of the job's
    device-packed I420), host ms a request. Before:
    ``rgb_to_yuv420_device`` on the card within 1 of cv2's
    ``COLOR_RGB2YUV_I420`` per byte on a smooth 224² image (cv2 takes each
    2x2 block's top-left chroma, the port and JAX their mean, so only on
    content smooth over 2x2 blocks are they that close), and within 1 of
    the CPU's packing on noise."""
    import cv2
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.tasks.camera import (
        rgb_to_yuv420,
        rgb_to_yuv420_device,
    )
    from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

    yy, xx = np.mgrid[0:224, 0:224]
    smooth = np.stack([yy * 200 // 224 + 20, xx * 180 // 224 + 30, (yy + xx) * 100 // 448 + 60],
                      -1).astype(np.uint8)
    card = rgb_to_yuv420_device(torch.from_numpy(smooth).to(DEVICE)).cpu().numpy()
    cv2_gap = _u8_gap(card, cv2.cvtColor(smooth, cv2.COLOR_RGB2YUV_I420))
    noise = np.random.RandomState(175).randint(0, 256, (8, 224, 224, 3)).astype(np.uint8)
    packed = rgb_to_yuv420_device(torch.from_numpy(noise).to(DEVICE)).cpu().numpy()
    cpu = rgb_to_yuv420_device(torch.from_numpy(noise)).numpy()
    cpu_gap, cpu_diff = _u8_gap(packed, cpu), int((packed != cpu).sum())
    print(f"[family3_serve] rgb_to_yuv420_device on the card: a smooth 224² image within "
          f"{cv2_gap} of cv2's COLOR_RGB2YUV_I420; 8 noise images within {cpu_gap} of the CPU's "
          f"packing ({cpu_diff} of {packed.size} bytes differ)")
    _require(cv2_gap <= 1 and cpu_gap <= 1, "the device I420 packer agrees with cv2 and the CPU")
    out = {"packer_cv2_gap": cv2_gap, "packer_cpu_gap": cpu_gap, "packer_cpu_bytes_differ":
           cpu_diff}
    canvases = np.random.RandomState(176).randint(0, 256, (F3S_REQUESTS, 224, 224, 3)).astype(
        np.uint8)
    total = {}
    for norm in ("instance", "batch"):
        cfg = os.path.join(tmp, f"f3serve_{norm}.json")
        with open(cfg, "w") as f:
            json.dump(family3[norm][2].to_dict(), f)
        per_iter = {"gram_fwd": F3_GRAMS, "gram_bwd": F3_GRAMS}
        if norm == "instance":
            per_iter.update(instance_norm_fwd=F3_NORMS, instance_norm_bwd=F3_NORMS)
        for transport in ("rgb", "yuv420"):
            with _deterministic_cudnn():
                srv, service, url = _serve([
                    "--family", "multi_patchgan", "--config_path", cfg, "--model_path",
                    os.path.join(tmp, f"family3_{norm}.npz"), "--num_iterations", str(F3S_ITERS),
                    "--threshold", "0", "--batch_size", "1", "--max_delay_ms", "5",
                    "--transport", transport, "--port", "0", "--device", DEVICE])
                try:
                    torch.cuda.synchronize()
                    kernels.reset_launch_counts()
                    served, ms = [], []
                    for canvas in canvases:
                        t0 = time.perf_counter()
                        status, png, headers = _post_raw(url, canvas)
                        ms.append((time.perf_counter() - t0) * 1e3)
                        _require(status == 200 and headers["X-Iterations"] == str(F3S_ITERS),
                                 f"a family-3 {transport} reply: {status} {headers}")
                        served.append(decode_png(png))
                    torch.cuda.synchronize()
                    launches = kernels.launch_counts()
                    gaps = []
                    for j, canvas in enumerate(canvases):
                        job_in = rgb_to_yuv420(canvas) if transport == "yuv420" else canvas
                        pixels = service._jobs_by_size[1](
                            job_in[None], np.zeros((1, 1), np.float32),
                            np.full((1,), j, np.int32))[0].cpu().numpy()[0]
                        if transport == "yuv420":
                            pixels = cv2.cvtColor(pixels, cv2.COLOR_YUV2RGB_I420)
                        gaps.append(_u8_gap(served[j], pixels))
                finally:
                    _stop(srv, service)
            want = {k: 0 for k in launches}
            for k, n in per_iter.items():
                want[k] = F3S_REQUESTS * n * (F3S_ITERS + (k.endswith("fwd")))
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            key = f"{norm}_{transport}"
            out[key] = {"ms_per_request": ms, "launches": launches, "served_vs_in_process": gaps}
            timings[f"family3_serve_{key}_ms"] = float(np.median(ms))
            print(f"[family3_serve] norm {norm}, {transport}: {F3S_REQUESTS} POSTs of 224² at b1, "
                  f"{F3S_ITERS} iterations: {[round(t, 1) for t in ms]} ms a request (host "
                  f"clock, HTTP to PNG); launches {({k: v for k, v in launches.items() if v})}; "
                  f"served vs in-process pixels max gap {gaps}")
            _require(launches == want, f"family-3 serving launches {want}: {launches}")
            _require(all(g <= 1 for g in gaps) and all(s.shape == (224, 224, 3) for s in served),
                     f"the served {transport} pixels equal the in-process texture loop's")
    out["launches"] = total
    return out


def phase_dispatch(kernels, family1, tmp: str, timings: dict) -> dict:
    """``--steps_per_dispatch``: (a) family 1's ``--mode classification``
    CLI (truncate 8, b32, 4 batches of 256² PNGs) at K = 4 and K = 1,
    metrics.txt byte for byte (the CLI stops at confusion_matrix.png where
    matplotlib is missing, after metrics.txt); (b) the family-1 eval loop
    over DISPATCH_EVAL_BATCHES in-memory b32 batches timed at K = 1 and K =
    DISPATCH_K, in turns (1, 4, 4, 1); (c) a family-2 training epoch
    (truncate 7, S 7, b32, DISPATCH_TRAIN_BATCHES batches: a chunk of 4 and
    a tail of 1) at K = 4 against K = 1 from the same weights, under cuDNN's
    deterministic algorithms: every parameter and running statistic and
    every per-batch print equal, and both epochs timed after a warm-up
    step."""
    import contextlib
    import importlib.util
    import io

    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import main as cli
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.tasks.classification import (
        evaluate_classification,
    )
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import train_epochs

    model, _, forward = family1
    data = _image_folder(os.path.join(tmp, "dispatch_data"), F1_BATCH, seed=180)
    cfg = os.path.join(tmp, "dispatch_f1.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": F1_BATCH, "truncate_layer": F1_TRUNCATE, "dim": F1_DIM,
                   "seed": 0}, f)
    have_matplotlib = importlib.util.find_spec("matplotlib") is not None
    metrics = {}
    for k in (1, DISPATCH_K):
        save = os.path.join(tmp, f"dispatch_k{k}")
        try:
            cli(["--data", data, "--config_path", cfg, "--model_path",
                 os.path.join(tmp, "family1.npz"), "--mode", "classification", "--save_dir", save,
                 "--prob_threshold", "0", "--steps_per_dispatch", str(k), "--device", DEVICE])
        except ModuleNotFoundError as e:
            if have_matplotlib or e.name != "matplotlib":
                raise
        with open(os.path.join(save, "metrics.txt"), "rb") as f:
            metrics[k] = f.read()
    equal = metrics[1] == metrics[DISPATCH_K]
    print(f"[dispatch] family-1 --mode classification CLI, {4 * F1_BATCH} PNGs at b{F1_BATCH}: "
          f"metrics.txt at --steps_per_dispatch {DISPATCH_K} byte-equal to 1: {equal} "
          f"({len(metrics[1])} bytes)")
    _require(equal and len(metrics[1]) > 0, "metrics.txt equal at K = 4 and K = 1")
    out = {"metrics_equal": equal}

    rng = np.random.RandomState(181)
    batches = [{"image": rng.randint(0, 256, (F1_BATCH, 256, 256, 3)).astype(np.uint8),
                "label": rng.randint(0, 4, (F1_BATCH,)).astype(np.int32), "n_valid": F1_BATCH,
                "indices": np.arange(F1_BATCH)} for _ in range(DISPATCH_EVAL_BATCHES)]
    evaluate_classification(forward, model, batches[:2], 4, prob_threshold=0.0)  # warm-up
    runs = {1: [], DISPATCH_K: []}
    for k in (1, DISPATCH_K, DISPATCH_K, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_classification(forward, model, batches, 4, prob_threshold=0.0,
                                      steps_per_dispatch=k)
        runs[k].append(len(batches) * F1_BATCH / (time.perf_counter() - t0))
        out.setdefault("probs", {})[k] = res["probs"]
    same = np.array_equal(out["probs"][1], out["probs"][DISPATCH_K])
    out.pop("probs")
    out["eval_images_per_s"] = {str(k): v for k, v in runs.items()}
    timings["dispatch_eval_k1_images_per_s"] = float(np.mean(runs[1]))
    timings[f"dispatch_eval_k{DISPATCH_K}_images_per_s"] = float(np.mean(runs[DISPATCH_K]))
    print(f"[dispatch] family-1 eval loop, {DISPATCH_EVAL_BATCHES} b{F1_BATCH} batches (host "
          f"clock, upload to metrics on the host), images/s in turns: K=1 "
          f"{[round(v, 1) for v in runs[1]]}, K={DISPATCH_K} "
          f"{[round(v, 1) for v in runs[DISPATCH_K]]}; probabilities equal {same}")
    _require(same, "the eval loop's probabilities at K = 4 equal K = 1's")

    cfg2 = GramAttentionConfig(batch_size=F2T_BATCH, lr=F2T_LR, truncate_layer=F2T_TRUNCATE,
                               gram_matrix_size=F2T_S)
    train = [{"image": rng.randint(0, 256, (F2T_BATCH, 256, 256, 3)).astype(np.uint8),
              "label": rng.randint(0, 4, (F2T_BATCH,)).astype(np.int32), "n_valid": F2T_BATCH}
             for _ in range(DISPATCH_TRAIN_BATCHES)]
    epochs = {}
    with _deterministic_cudnn():
        warm = setup_gram_attention(cfg2, 4, [(None, None)], device=DEVICE)
        warm.train_step(*warm.init(None), train[0]["image"], train[0]["label"])
        del warm
        for k in (1, DISPATCH_K):
            setup = setup_gram_attention(cfg2, 4, [(None, None)], device=DEVICE)
            m, opt = setup.init(torch.Generator().manual_seed(182))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                train_epochs(setup.train_step, m, opt, train, 1, steps_per_dispatch=k)
            torch.cuda.synchronize()
            epochs[k] = (time.perf_counter() - t0, printed.getvalue(),
                         {n: t.detach().cpu() for n, t in m.state_dict().items()})
            del m, opt, setup
    (s1, p1, w1), (sk, pk, wk) = epochs[1], epochs[DISPATCH_K]
    differ = [n for n in w1 if not torch.equal(w1[n], wk[n])]
    print(f"[dispatch] family-2 epoch of {DISPATCH_TRAIN_BATCHES} b{F2T_BATCH} steps: K=1 "
          f"{s1:.3f} s, K={DISPATCH_K} {sk:.3f} s (host clock, after one warm-up step); "
          f"per-batch prints equal {p1 == pk}; {len(differ)} of {len(w1)} leaves differ "
          f"{differ[:3]}")
    _require(p1 == pk and not differ, "the family-2 epoch at K = 4 equals K = 1 bit for bit")
    out.update(train_epoch_s={"1": s1, str(DISPATCH_K): sk}, train_leaves_differ=differ)
    return out


def phase_grad_accum(kernels, tmp: str, timings: dict) -> dict:
    """``--grad_accum 4`` at b32: (a) family 3 (the config defaults, norm
    "instance": no batch statistics) one step against the full-batch step
    from the same weights, which is its truth: both held against that
    step in float64 on the CPU, the loss within 1e-5 relative and each
    leaf's move by relative L2 within max(ACCUM_TOL, twice the card's
    full-batch f32 step's error at its worst leaf) (only f32 reassociation
    differs: the micro-batches' gradient sums are added, then divided, and
    cuDNN picks other algorithms at b8; the weight gradients after an
    instance norm cancel heavily; the zero-gradient biases excepted); (b)
    family 2 (truncate 7,
    S 7: ghost batch norm) one step against a hand-written loop over the
    four micro-batches of 8 (each one train-mode forward, the unnormalised
    masked NLL's gradients summed, divided once by the valid count, one SGD
    update), every parameter and running statistic bit for bit under cuDNN's
    deterministic algorithms; (c) the family-2 step plain and accumulated
    by ``_timed_step``."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.config.schema import (
        GramAttentionConfig,
        MultiPatchGANConfig,
    )
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.train.factories import (
        setup_gram_attention,
        setup_multi_patchgan,
    )
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import _masked_nll_parts

    rng = np.random.RandomState(185)
    u8 = rng.randint(0, 256, (F2T_BATCH, 256, 256, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, (F2T_BATCH,)).astype(np.int32)
    labels[3] = -1  # a pad entry in the first micro-batch
    out = {}

    f3cfg = MultiPatchGANConfig(batch_size=F3T_BATCH, lr=F3T_LR, norm="instance", seed=0)
    t0 = time.perf_counter()
    ref = setup_multi_patchgan(f3cfg, 4, [(None, None)], compute_dtype=torch.float64,
                               device="cpu")
    model, opt = ref.init(torch.Generator().manual_seed(186))
    model.double()
    opt = ref.optimizer[0](model)
    start = {n: t.detach().clone() for n, t in model.state_dict().items()}
    _, _, ref_loss = ref.train_step(model, opt, u8, labels)
    truth = {n: t.detach() - start[n] for n, t in model.state_dict().items()}
    t_cpu = time.perf_counter() - t0
    del model, opt, ref
    f3 = setup_multi_patchgan(f3cfg, 4, [(None, None)], device=DEVICE)
    moved = {}
    for name, step in (("full", f3.train_step), ("accum", f3.accum_step(ACCUM_K))):
        model, opt = f3.init(torch.Generator().manual_seed(186))
        _, _, loss = step(model, opt, u8, labels)
        moved[name] = (float(loss), {n: t.detach().cpu().double() - start[n]
                                     for n, t in model.state_dict().items()})
        del model, opt
    real = [n for n in truth if not _f3_zero_grad(n)]

    def errs(moves):
        return {n: float((moves[n] - truth[n]).norm() / truth[n].norm()) for n in real}

    (full_loss, full), (loss, accum) = moved["full"], moved["accum"]
    e_full, e_accum = errs(full), errs(accum)
    tol = max(ACCUM_TOL, 2 * max(e_full.values()))
    worst = max(real, key=e_accum.get)
    rel = abs(loss - float(ref_loss)) / abs(float(ref_loss))
    print(f"[grad_accum] family-3 instance b{F3T_BATCH} step at --grad_accum {ACCUM_K}, each "
          f"leaf's move against the full-batch step on the CPU in float64 ({t_cpu:.1f} s): loss "
          f"{loss:.9f} vs {float(ref_loss):.9f} (rel {rel:.2e}; the card's full batch "
          f"{full_loss:.9f}); worst leaf {e_accum[worst]:.2e} at {worst}, the full batch's "
          f"there {e_full[worst]:.2e} and at its worst leaf {max(e_full.values()):.2e} (tol "
          f"{tol:.2e}: max({ACCUM_TOL}, 2x the full-batch step's worst leaf))")
    _require(rel <= 1e-5 and e_accum[worst] <= tol,
             "family 3's accumulated step equals the full-batch step")
    out["family3_instance"] = {"loss_rel": rel, "worst_rel_l2": e_accum[worst],
                               "worst_leaf": worst, "tol": tol,
                               "largest_accum": max(e_accum.values()),
                               "largest_full": max(e_full.values()), "cpu_seconds": t_cpu}

    cfg2 = GramAttentionConfig(batch_size=F2T_BATCH, lr=F2T_LR, truncate_layer=F2T_TRUNCATE,
                               gram_matrix_size=F2T_S)
    f2 = setup_gram_attention(cfg2, 4, [(None, None)], device=DEVICE)
    augment = make_augment_fn([(None, None)])
    with _deterministic_cudnn():
        model, opt = f2.init(torch.Generator().manual_seed(187))
        _, _, loss = f2.accum_step(ACCUM_K)(model, opt, u8, labels)
        accum = {n: t.detach().cpu() for n, t in model.state_dict().items()}
        del model, opt
        model, _ = f2.init(torch.Generator().manual_seed(187))
        params = dict(model.named_parameters())
        names = list(params)
        images = augment(torch.as_tensor(u8).to(DEVICE))
        labels_d = torch.as_tensor(labels).to(DEVICE)
        mb = F2T_BATCH // ACCUM_K
        g_sum, nll_sum, cnt_sum = None, 0.0, 0.0
        for i in range(ACCUM_K):
            part = slice(i * mb, (i + 1) * mb)
            logits = gram_attention_apply(model, images[part], F2T_TRUNCATE, F2T_S, 4)[1]
            nll, cnt = _masked_nll_parts(logits, labels_d[part])
            grads = torch.autograd.grad(nll, [params[n] for n in names])
            g_sum = list(grads) if g_sum is None else [a + g for a, g in zip(g_sum, grads)]
            nll_sum, cnt_sum = nll_sum + nll.detach(), cnt_sum + cnt
        with torch.no_grad():  # SGD's first update: the trace is the gradient
            for n, g in zip(names, g_sum):
                params[n].add_((g / cnt_sum) * -F2T_LR)
        hand = {n: t.detach().cpu() for n, t in model.state_dict().items()}
        hand_loss = float(nll_sum / cnt_sum)
        del model
    differ = [n for n in hand if not torch.equal(hand[n], accum[n])]
    print(f"[grad_accum] family-2 b{F2T_BATCH} step at --grad_accum {ACCUM_K} vs a hand-written "
          f"loop over {ACCUM_K} micro-batches (cuDNN deterministic): loss {float(loss):.9f} vs "
          f"{hand_loss:.9f}; {len(differ)} of {len(hand)} leaves differ {differ[:3]}")
    _require(float(loss) == hand_loss and not differ,
             "family 2's accumulated step equals the hand-written micro-batch loop")
    out["family2"] = {"leaves_differ": differ}

    for name, step in (("plain", f2.train_step), ("accum", f2.accum_step(ACCUM_K))):
        model, opt = f2.init(torch.Generator().manual_seed(188))
        out["family2"][name] = _timed_step("grad_accum family2", name, lambda i=0: step(
            model, opt, u8, labels), F2T_BATCH, REMAT_TIMED)
        timings[f"grad_accum_family2_{name}_step_ms"] = out["family2"][name]["step_ms"]
        del model, opt
    return out


def phase_profile_debug(kernels, tmp: str, timings: dict) -> dict:
    """(a) ``--profile_dir`` on the family-2 CLI's ``--mode style_transfer``
    (the classification phase's model, truncate 8, layers 5, 2 images, 2
    iterations): the Chrome trace it writes names the hand-written kernels
    (``gram_fwd``, ``gram_bwd``). (b) ``--debug_nans``: a clean
    classification run ends normally; with one conv weight set to NaN the
    CLI, in a process of its own, exits non-zero with FloatingPointError."""
    import numpy as np

    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
        load_pytree_npz,
        save_pytree_npz,
    )
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main as cli

    data = _image_folder(os.path.join(tmp, "pd_data"), 1, seed=190)
    cfg = os.path.join(tmp, "pd_f2.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 2, "truncate_layer": 8, "gram_matrix_size": POOL_S, "seed": 0},
                  f)
    ckpt = os.path.join(tmp, "family2.npz")
    prof = os.path.join(tmp, "pd_profile")
    t0 = time.perf_counter()
    cli(["--data", data, "--config_path", cfg, "--model_path", ckpt, "--mode",
         "style_transfer", "--layers", "5", "--num_iterations", "2", "--num_samples", "2",
         "--save_dir", os.path.join(tmp, "pd_st"), "--profile_dir", prof, "--device", DEVICE])
    traces = [n for n in os.listdir(prof) if n.endswith(".pt.trace.json")]
    with open(os.path.join(prof, traces[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    named = {k: sorted(n for n in names if k in n)[:3] for k in ("gram_fwd", "gram_bwd")}
    print(f"[profile_debug] --profile_dir on --mode style_transfer: {traces} "
          f"({time.perf_counter() - t0:.1f} s with the trace), kernels named {named}")
    _require(len(traces) == 1 and all(named.values()),
             "the profile's trace names gram_fwd and gram_bwd")

    cli(["--data", data, "--config_path", cfg, "--model_path", ckpt, "--mode", "classification",
         "--save_dir", os.path.join(tmp, "pd_clean"), "--debug_nans", "--device", DEVICE])
    tree = load_pytree_npz(ckpt)
    tree["encoder"]["layer1"][0]["conv2"]["kernel"][0, 0, 0, 0] = np.nan
    nan_ckpt = os.path.join(tmp, "pd_nan.npz")
    save_pytree_npz(tree, nan_ckpt)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.cli.test_gram_attention", "--data", data, "--config_path",
         cfg, "--model_path", nan_ckpt, "--mode", "classification", "--save_dir",
         os.path.join(tmp, "pd_nan"), "--debug_nans", "--device", DEVICE],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    print(f"[profile_debug] --debug_nans: a clean run ended normally; with a NaN weight the CLI "
          f"exited {proc.returncode} in {time.perf_counter() - t0:.1f} s: {last}")
    _require(proc.returncode != 0 and "FloatingPointError" in last,
             "--debug_nans stops a NaN forward with FloatingPointError")
    return {"traces": traces, "kernels_named": named, "nan_exit": proc.returncode,
            "nan_error": last}


# ------------------------------------------ EMA and mixing, auto-batch, int8


def _mixed_step(model, forward, u8, labels, mix_fn, mix_key, decay):
    """One train step of ``model`` (train mode) through
    ``make_train_step_body`` with ``mix_fn`` and, with ``decay``, the
    parameter EMA, as ``_step_grads`` reports a step: (loss, the gradients
    by name and, under "ema:<name>", the EMA's leaves, on the host; the
    running statistics). The EMA's own move is (1 - decay) x the step's,
    far below an f32 leaf's rounding, so each leaf is also held bit for bit
    to its recurrence decay * init + (1 - decay) * p_new, recomputed from
    the step's updated parameters."""
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.train.optim import sgd_momentum
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import make_train_step_body

    init, update = sgd_momentum(F2T_LR, ema_decay=decay)
    grads = {}

    def capture(m, g, state):
        grads.update({n: t.detach().cpu() for n, t in g.items()})
        update(m, g, state)

    dtype = next(model.parameters()).dtype
    step = make_train_step_body(lambda m, x: forward(m, x.to(dtype)), (init, capture),
                                make_augment_fn([(None, None)]), 0.0, mix_fn)
    state = init(model)
    start = {n: e.detach().clone() for n, e in state.get("ema", {}).items()}
    _, state, loss = step(model, state, u8, labels, mix_key=mix_key)
    params = dict(model.named_parameters())
    gap = max([float((state["ema"][n] - (start[n] * decay + params[n].detach() * (1.0 - decay)))
                     .abs().max()) for n in start], default=0.0)
    _require(gap == 0.0, f"the EMA is its recurrence bit for bit: {gap}")
    grads.update({f"ema:{n}": state["ema"][n].detach().cpu() for n in start})
    stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(loss), grads, stats


def _mixed_step_vs_cpu(tag: str, make_model, forward, u8, labels, mix_fn, mix_key, decay,
                       zero_grad=lambda name: False) -> dict:
    """``_step_vs_cpu`` over ``_mixed_step``: the mixed loss, every
    gradient and every EMA leaf ("ema:<name>") held as gradients are."""

    def step_grads(model, forward, augment, u8, labels, combos, draws):
        return _mixed_step(model, forward, u8, labels, mix_fn, mix_key, decay)

    return _step_vs_cpu(tag, make_model, forward, None, u8, labels, zero_grad=zero_grad,
                        step_grads=step_grads)


def _cutmix_key(mix_fn_args, batch: int):
    """The first key (0, 0, 0, i) whose draws pick CutMix under both
    flags (``mix_fn_args`` = (mixup alpha, cutmix alpha))."""
    from heuristique_style_transfer_code_tpu_torch.train.mixing import mix_draws

    for i in range(64):
        key = (0, 0, 0, i)
        if mix_draws(key, batch, 224, 224, True, True, *mix_fn_args)[0]:
            return key
    raise RuntimeError("no CutMix key among the first 64")


def phase_ema_mix(kernels, tmp: str, timings: dict) -> dict:
    """``--ema_decay``, ``--mixup`` and ``--cutmix`` at full width.

    (a) Family 2 at the config defaults (truncate 7, S 7, b32): one f32
    step with the EMA (decay 0.999) and both mixings (a key whose coin
    picks CutMix) against the same step on the CPU in float64 from the
    same weights, batch and draws (``_mixed_step_vs_cpu``: the loss, every
    gradient and every EMA leaf), and one step's launches on the
    card: 3 pooled_gram_fwd and 3 pooled_gram_bwd. (b) Family 3 at norm
    "instance" (the config defaults) under ``--mixup 0.2``: 13
    instance_norm_fwd and 13 instance_norm_bwd a b32 step, and a b8 step
    against the CPU as in (a) (the CPU's float64 step at b32 takes 15 s).
    (c) The family-2 CLI on 96 PNGs, 2 folds x 2 epochs, with all three
    flags: exact launches; every ``best_model_fold_<k>.npz`` equals the
    EMA tree ``extract_ema_variables`` gave at its fold's end, bit for
    bit; then ``--resume`` stopped by a real SIGTERM and resumed, equal to
    the uninterrupted run bit for bit (cuDNN's deterministic algorithms).
    (d) The b32 family-2 step with the three flags beside the plain step,
    f32 and bf16: F2T_TIMED steps on the host clock, 3 profiled, launches
    a step."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli.train_gram_attention import main as train_cli
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_apply,
        multiscale_init,
    )
    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.train import optim as po
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention
    from heuristique_style_transfer_code_tpu_torch.train.mixing import make_mix_fn

    cfg = GramAttentionConfig(batch_size=F2T_BATCH, lr=F2T_LR, truncate_layer=F2T_TRUNCATE,
                              gram_matrix_size=F2T_S, seed=0)
    rng = np.random.RandomState(300)
    u8 = [rng.randint(0, 256, (F2T_BATCH, 256, 256, 3)).astype(np.uint8) for _ in range(2)]
    labels = [rng.randint(0, 4, (F2T_BATCH,)).astype(np.int32) for _ in range(2)]
    labels[0][-1] = -1
    mix = make_mix_fn(MIXUP, CUTMIX)
    key = _cutmix_key((MIXUP, CUTMIX), F2T_BATCH)
    stages = F2T_TRUNCATE - 4
    out = {"cutmix_key": list(key)}

    # (a) family 2: launches and card vs CPU
    def make_f2(device):
        return gram_attention_init(torch.Generator().manual_seed(301), F2T_TRUNCATE, 4, F2T_S,
                                   device=device).train()

    def forward_f2(model, images):
        return gram_attention_apply(model, images, F2T_TRUNCATE, F2T_S, 4)[1]

    setup = setup_gram_attention(cfg, 4, [(None, None)], ema_decay=EMA_DECAY, mix_fn=mix,
                                 device=DEVICE)
    model, opt = setup.init(torch.Generator().manual_seed(302))
    setup.train_step(model, opt, u8[0], labels[0], mix_key=key)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    setup.train_step(model, opt, u8[1], labels[1], mix_key=(0, 0, 1, 0))
    torch.cuda.synchronize()
    step_launches = kernels.launch_counts()
    want = {k: 0 for k in step_launches}
    want.update(pooled_gram_fwd=stages, pooled_gram_bwd=stages)
    print(f"[ema_mix] one b{F2T_BATCH} family-2 step with --ema_decay {EMA_DECAY} --mixup "
          f"{MIXUP} --cutmix {CUTMIX}: launches {step_launches}")
    _require(step_launches == want, f"one mixed family-2 step's launches {want}")
    del model, opt, setup
    out["family2_step_launches"] = step_launches
    out["family2_card_vs_cpu"] = _mixed_step_vs_cpu("ema_mix family2", make_f2, forward_f2,
                                                    u8[0], labels[0], mix, key, EMA_DECAY)

    # (b) family 3 at norm "instance" under --mixup
    f3cfg = MultiPatchGANConfig(batch_size=F3T_BATCH, lr=F3T_LR, norm="instance", seed=0)
    mixup = make_mix_fn(MIXUP, None)

    def make_f3(device):
        return multiscale_init(torch.Generator().manual_seed(303), f3cfg.patch_sizes,
                               ndf=f3cfg.ndf, num_classes=4, norm="instance",
                               device=device).train()

    def forward_f3(model, images):
        return multiscale_apply(model, images, "instance", train=True)

    f3 = make_f3(DEVICE)
    _mixed_step(f3, forward_f3, u8[0], labels[0], mixup, key, None)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _mixed_step(f3, forward_f3, u8[1], labels[1], mixup, key, None)
    torch.cuda.synchronize()
    f3_launches = kernels.launch_counts()
    want = {k: 0 for k in f3_launches}
    want.update(instance_norm_fwd=F3_NORMS, instance_norm_bwd=F3_NORMS)
    print(f"[ema_mix] one b{F3T_BATCH} family-3 step (norm instance) with --mixup {MIXUP}: "
          f"launches {f3_launches}")
    _require(f3_launches == want, f"one mixed family-3 step's launches {want}")
    del f3
    out["family3_step_launches"] = f3_launches
    out["family3_card_vs_cpu"] = _mixed_step_vs_cpu(
        "ema_mix family3", make_f3, forward_f3, u8[0][:EM_F3_CPU_BATCH],
        labels[0][:EM_F3_CPU_BATCH], mixup, key, None, zero_grad=_f3_zero_grad)

    # (c) the family-2 CLI with the three flags: launches, the EMA
    # artifacts, preemption and resume
    data = _image_folder(os.path.join(tmp, "em_data"), F2T_PER_CLASS, seed=304, split="train")
    cfg_path = os.path.join(tmp, "em.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    base = ["--data", data, "--config_path", cfg_path, "--k_folds", "2", "--epochs", "2",
            "--ema_decay", str(EMA_DECAY), "--mixup", str(MIXUP), "--cutmix", str(CUTMIX),
            "--device", DEVICE]
    trees, real = [], po.extract_ema_variables

    def recording(model, opt_state):
        ev = real(model, opt_state)
        trees.append(_flatten(to_jax_tree(ev)))
        return ev

    a = os.path.join(tmp, "em_a")
    with _deterministic_cudnn():
        po.extract_ema_variables = recording
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            _train_cli(train_cli, base + ["--save_dir", a])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            cli_launches = kernels.launch_counts()
        finally:
            po.extract_ema_variables = real
        resume = _resume_vs_uninterrupted("ema_mix", train_cli, base, tmp, "em",
                                          ["best_model_fold_0.npz", "best_model_fold_1.npz"])
    want = {k: 0 for k in cli_launches}
    want.update(pooled_gram_fwd=(8 + 4) * stages, pooled_gram_bwd=8 * stages)
    differ = []
    for fold, tree in enumerate(trees):
        saved = _flatten(load_pytree_npz(os.path.join(a, f"best_model_fold_{fold}.npz")))
        differ += [f"{fold}:{k}" for k in tree if not np.array_equal(saved[k], tree[k])]
    print(f"[ema_mix] CLI with the three flags, 2 folds x 2 epochs at b{F2T_BATCH}: {cli_s:.1f} "
          f"s, launches {cli_launches}; {len(trees)} EMA trees taken, fold checkpoint leaves "
          f"that differ from them: {len(differ)} {differ[:4]}")
    _require(cli_launches == want, f"the CLI's launches {want}: {cli_launches}")
    _require(len(trees) == 2 and not differ, "each fold checkpoint is the EMA tree")
    timings["ema_mix_cli_s"] = cli_s
    out["cli"] = {"seconds": cli_s, "launches": cli_launches, "ema_trees": len(trees),
                  "leaves_differ_from_ema": differ, **resume}

    # (d) the step with and without the three flags
    for dtype in (None, torch.bfloat16):
        for flags in ("plain", "ema_mix"):
            name = f"{flags} {'float32' if dtype is None else 'bfloat16'}"
            setup = setup_gram_attention(
                cfg, 4, [(None, None)], compute_dtype=dtype,
                ema_decay=EMA_DECAY if flags == "ema_mix" else None,
                mix_fn=mix if flags == "ema_mix" else None, device=DEVICE)
            model, opt = setup.init(torch.Generator().manual_seed(305))

            def step(i=0, setup=setup, model=model, opt=opt):
                setup.train_step(model, opt, u8[i % 2], labels[i % 2], mix_key=(0, 0, 2, i))

            kernels.reset_launch_counts()
            out[name] = _timed_step("ema_mix", name, step, F2T_BATCH, F2T_TIMED)
            out[name]["launches_per_step"] = {
                k: v / (F2T_TIMED + 4) for k, v in kernels.launch_counts().items() if v}
            timings[f"ema_mix_{name.replace(' ', '_')}_step_ms"] = out[name]["step_ms"]
            del model, opt, setup
    out["launches"] = {k: cli_launches[k] + step_launches[k] + f3_launches[k]
                       for k in cli_launches}
    return out


def phase_auto_batch(kernels, tmp: str, timings: dict) -> dict:
    """``--auto_batch --hbm_budget_gb 16`` on family 1's train CLI at full
    width (truncate 8, dim 256, configured b32, f32, 4 classes x
    AB_PER_CLASS PNGs, 2 folds, 1 epoch): the probe report (one real step
    a candidate, the allocator's peak, which must rise with the batch),
    the adopted batch, its first real step's peak memory under 0.95 x the
    budget by ``max_memory_allocated``, the adopted batch in the saved
    hyperparameters, and ``device_hbm_bytes`` for the card."""
    import contextlib
    import io

    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.train_truncated_resnet50 import (
        main as train_cli,
    )
    from heuristique_style_transfer_code_tpu_torch.train import autotune, kfold

    data = _image_folder(os.path.join(tmp, "ab_data"), AB_PER_CLASS, seed=310, split="train")
    cfg_path = os.path.join(tmp, "ab.json")
    with open(cfg_path, "w") as f:
        json.dump({"batch_size": F1T_BATCH, "lr": F1T_LR, "truncate_layer": F1_TRUNCATE,
                   "dim": F1_DIM, "seed": 0}, f)
    save = os.path.join(tmp, "ab_out")
    probes, first = {}, {}
    real_probe, real_epochs = autotune.train_step_peak_bytes, kfold.train_epochs

    def probe(setup, batch, canvas, device, mesh=None):
        t0 = time.perf_counter()
        peak = real_probe(setup, batch, canvas, device, mesh=mesh)
        probes[batch] = {"peak_bytes": peak, "seconds": time.perf_counter() - t0}
        return peak

    def watched(train_step, *args, **kwargs):
        def step(*a, **k):
            if "peak_bytes" in first:
                return train_step(*a, **k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = train_step(*a, **k)
            torch.cuda.synchronize()
            first["peak_bytes"] = torch.cuda.max_memory_allocated()
            return res
        return real_epochs(step, *args, **kwargs)

    autotune.train_step_peak_bytes, kfold.train_epochs = probe, watched
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            _train_cli(train_cli, ["--data", data, "--config_path", cfg_path, "--k_folds", "2",
                                   "--epochs", "1", "--save_dir", save, "--auto_batch",
                                   "--hbm_budget_gb", str(AB_BUDGET_GB), "--device", DEVICE])
    finally:
        autotune.train_step_peak_bytes, kfold.train_epochs = real_probe, real_epochs
    cli_s = time.perf_counter() - t0
    text = printed.getvalue()
    report = [line for line in text.splitlines() if "budget" in line or "batch" in line[:9]
              or line.startswith("--auto_batch")]
    print("\n".join(f"[auto_batch] {line}" for line in report))
    with open(os.path.join(save, "best_global_model_hyperparameters.json")) as f:
        adopted = json.load(f)["batch_size"]
    peaks = [probes[b]["peak_bytes"] for b in sorted(probes)]
    hbm = autotune.device_hbm_bytes(DEVICE)
    limit = 0.95 * AB_BUDGET_GB * autotune.GIB
    table = {b: (round(p["peak_bytes"] / autotune.GIB, 3), round(p["seconds"], 2))
             for b, p in sorted(probes.items())}
    print(f"[auto_batch] probes (batch: GiB, s) {table}; "
          f"adopted batch {adopted} (the saved hyperparameters; training_info.json holds no "
          f"batch in either package); its first real step's peak "
          f"{first.get('peak_bytes', 0) / autotune.GIB:.3f} GiB against {limit / autotune.GIB:.2f} "
          f"GiB usable; device_hbm_bytes {hbm} ({hbm / autotune.GIB:.2f} GiB); the CLI "
          f"{cli_s:.1f} s")
    _require(len(peaks) >= 2 and all(a < b for a, b in zip(peaks, peaks[1:])),
             "the probes' peaks rise with the batch")
    _require(adopted > F1T_BATCH and f"adopting batch {adopted}" in text,
             "a larger batch than the configured one is adopted")
    _require(0 < first.get("peak_bytes", 0) <= limit,
             "the adopted batch's first step fits the budget")
    timings["auto_batch_cli_s"] = cli_s
    return {"probes": probes, "adopted": adopted, "first_step_peak_bytes": first["peak_bytes"],
            "budget_bytes": AB_BUDGET_GB * autotune.GIB, "device_hbm_bytes": hbm,
            "cli_seconds": cli_s, "report": report}


def _images_per_s(fn, staged, n: int) -> float:
    import torch

    fn(staged)
    fn(staged)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(staged)
    torch.cuda.synchronize()
    return staged.shape[0] * n / (time.perf_counter() - t0)


def phase_int8(kernels, family1, family2, tmp: str, timings: dict) -> dict:
    """``--precision int8`` at full width.

    (a) Family 1 (truncate 8, dim 256): the encoder calibrated on the card
    on INT8_CAL_BATCHES seeded b32 batches and quantised, written as
    ``q.npz``; one b32 batch's int8 logits on the card against the CPU's
    int8 forward from the same ``q.npz`` on its first 8 images (within
    INT8_TOL_LOGITS, argmax equal) and the int8 features against the f32
    ones on the card (cosine > 0.99 at every image). (b) b32 images/s from
    staged uint8 (preprocess, forward, logits) in int8, f32 and bf16 in
    this run, and one profiled int8 forward; INT8_CAMERA_FRAMES b1 camera
    frames in int8 (host-downscaled RGB), p50 and frames/s, frame 1
    against the CPU. (c) Family 2 (truncate 8, S 7, b8): calibrated and
    quantised on the card, one int8 forward launching 4 pooled_gram_fwd
    and nothing else, its logits against the CPU's. (d) The CLI
    ``test_truncated_resnet50 --precision int8 --calib_data D
    --quantized_path q.npz``: a first run writes ``q.npz``, a second loads
    it and writes metrics.txt byte for byte; then ``--qat_steps 2``
    fine-tunes on the card and prints JAX's loss line. The family-1 int8
    path launches no hand-written kernel (cuBLASLt and cuDNN work)."""
    import contextlib
    import importlib.util
    import io

    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli._common import cast_forward
    from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import main as cli
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply_int8,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply_int8,
    )
    from heuristique_style_transfer_code_tpu_torch.nn import resnet_int8 as q8
    from heuristique_style_transfer_code_tpu_torch.nn.resnet import resnet50_apply
    from heuristique_style_transfer_code_tpu_torch.tasks import camera as cam
    from heuristique_style_transfer_code_tpu_torch.tools.profile_main_path import _profile

    model, seeded, forward = family1
    rng = np.random.RandomState(320)
    u8 = [rng.randint(0, 256, (F1_BATCH, 256, 256, 3)).astype(np.uint8)
          for _ in range(INT8_CAL_BATCHES + 1)]
    staged = [torch.as_tensor(b).to(DEVICE) for b in u8]
    x = [eval_preprocess(s) for s in staged]
    out = {}

    # (a) PTQ on the card, card vs CPU, int8 vs f32
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    scales = q8.calibrate_activation_scales(model.moco.encoder, x[:INT8_CAL_BATCHES],
                                            F1_TRUNCATE)
    q = q8.quantize_resnet50(model.moco.encoder, scales, F1_TRUNCATE, device=DEVICE)
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    qpath = os.path.join(tmp, "int8_family1_q.npz")
    q8.save_quantized(q, qpath)
    q_cpu = q8.load_quantized(qpath, device="cpu")
    with torch.no_grad():
        logits = combined_apply_int8(q, model.moco, model.classifier, x[-1]).cpu()
        t0 = time.perf_counter()
        want = combined_apply_int8(q_cpu, seeded.moco, seeded.classifier, x[-1][:8].cpu())
        cpu_s = time.perf_counter() - t0
        gap = float((logits[:8] - want).abs().max())
        same_argmax = bool(torch.equal(logits[:8].argmax(1), want.argmax(1)))
        f_i8 = q8.resnet50_apply_int8(q, x[-1]).reshape(F1_BATCH, -1).double()
        f_32, _ = resnet50_apply(model.moco.encoder, x[-1], F1_TRUNCATE)
        f_32 = f_32.reshape(F1_BATCH, -1).double()
        cos = (f_i8 * f_32).sum(1) / (f_i8.norm(dim=1) * f_32.norm(dim=1))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[int8] family 1 PTQ on the card ({INT8_CAL_BATCHES} b{F1_BATCH} batches): "
          f"{ptq_s:.2f} s; b{F1_BATCH} int8 logits vs the CPU's int8 forward from the same "
          f"q.npz on 8 images ({cpu_s:.1f} s on the CPU): max |dlogit| {gap:.3e} (tol "
          f"{INT8_TOL_LOGITS}), argmax equal {same_argmax}; int8 vs f32 features on the card: "
          f"cosine min {float(cos.min()):.5f} (tol 0.99); launches {launches}")
    _require(gap <= INT8_TOL_LOGITS and same_argmax, "the card's int8 logits are the CPU's")
    _require(float(cos.min()) > 0.99, "int8 features keep cosine > 0.99 against f32")
    _require(not any(launches.values()), "the family-1 int8 path launches no hand-written kernel")
    out["family1"] = {"ptq_seconds": ptq_s, "logit_gap": gap, "argmax_equal": same_argmax,
                      "cosine_min": float(cos.min()), "cpu_seconds": cpu_s}

    # (b) images/s: int8 beside f32 and bf16, one profiled int8 forward, the camera
    fwds = {
        "int8": lambda s: combined_apply_int8(q, model.moco, model.classifier,
                                              eval_preprocess(s)),
        "float32": lambda s: forward(model, eval_preprocess(s)),
        "bfloat16": lambda s: cast_forward(forward, torch.bfloat16)(model, eval_preprocess(s)),
    }
    rates = {}
    with torch.no_grad():
        for name, fn in fwds.items():
            rates[name] = _images_per_s(fn, staged[-1], INT8_TIMED)
        prof = {name: _profile(lambda fn=fwds[name]: fn(staged[-1]), 3)
                for name in ("int8", "float32")}
    for name in prof:
        prof[name]["busy_ms_per_forward"] = prof[name]["device_busy_ms"] / 3
    print(f"[int8] family 1 b{F1_BATCH} images/s from staged uint8 (preprocess, forward, "
          f"logits; {INT8_TIMED} forwards on the host clock): "
          f"{ {k: round(v, 1) for k, v in rates.items()} }; busy a forward (3 profiled): "
          f"int8 {prof['int8']['busy_ms_per_forward']:.3f} ms, f32 "
          f"{prof['float32']['busy_ms_per_forward']:.3f} ms; int8 top kernels "
          f"{[(k['name'][:48], round(k['ms'] / 3, 3)) for k in prof['int8']['top_kernels'][:6]]}")
    for name, r in rates.items():
        timings[f"int8_family1_{name}_images_per_s"] = r
    out["images_per_s"] = rates
    out["profile"] = {k: {"busy_ms_per_forward": v["busy_ms_per_forward"],
                          "idle_share": v["idle_share"], "top_kernels": v["top_kernels"][:8]}
                      for k, v in prof.items()}

    frames = _camera_frames(321)["rgb224"][: INT8_CAMERA_FRAMES + 1]
    infer = cam.make_camera_infer_fn(
        lambda m, im: combined_apply_int8(q, m.moco, m.classifier, im), host_downscale=True)
    infer_cpu = cam.make_camera_infer_fn(
        lambda m, im: combined_apply_int8(q_cpu, m.moco, m.classifier, im), host_downscale=True)
    infer(model, frames[0]).cpu()
    times, first_probs = [], None
    for f in frames[1:]:
        t0 = time.perf_counter()
        p = infer(model, f).cpu()
        times.append(time.perf_counter() - t0)
        first_probs = p if first_probs is None else first_probs
    cam_gap = _probs_gap(first_probs.numpy(), infer_cpu(seeded, frames[1]).numpy())
    p50 = float(np.median(times)) * 1e3
    print(f"[int8] camera b1 int8, {len(times)} host-downscaled frames: p50 {p50:.3f} ms, "
          f"{len(times) / sum(times):.1f} frames/s; frame 1 vs the CPU's int8: {cam_gap:.3e} "
          f"of the largest probability (tol {INT8_TOL_LOGITS})")
    _require(cam_gap <= INT8_TOL_LOGITS, "the int8 camera path agrees with the CPU's")
    timings["int8_camera_p50_ms"] = p50
    out["camera"] = {"p50_ms": p50, "frames_per_s": len(times) / sum(times), "gap": cam_gap}

    # (c) family 2: pooled_gram_fwd on the dequantised stage maps
    f2, f2_seeded = family2
    xb = [x[i][:INT8_F2_BATCH] for i in range(INT8_CAL_BATCHES + 1)]
    scales2 = q8.calibrate_activation_scales(f2.encoder, xb[:INT8_CAL_BATCHES], 8)
    q2 = q8.quantize_resnet50(f2.encoder, scales2, 8, device=DEVICE)
    q2path = os.path.join(tmp, "int8_family2_q.npz")
    q8.save_quantized(q2, q2path)
    with torch.no_grad():
        gram_attention_apply_int8(q2, f2, xb[-1], POOL_S, 4)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        _, logits2 = gram_attention_apply_int8(q2, f2, xb[-1], POOL_S, 4)
        torch.cuda.synchronize()
        f2_launches = kernels.launch_counts()
        _, want2 = gram_attention_apply_int8(q8.load_quantized(q2path, device="cpu"),
                                             f2_seeded, xb[-1].cpu(), POOL_S, 4)
    gap2 = float((logits2.cpu() - want2).abs().max())
    want_l = {k: 0 for k in f2_launches}
    want_l.update(pooled_gram_fwd=4)
    print(f"[int8] family 2 b{INT8_F2_BATCH} int8 forward (truncate 8, S {POOL_S}): launches "
          f"{f2_launches}; logits vs the CPU's int8: max |dlogit| {gap2:.3e} (tol "
          f"{INT8_TOL_LOGITS})")
    _require(f2_launches == want_l, f"the family-2 int8 forward's launches {want_l}")
    _require(gap2 <= INT8_TOL_LOGITS, "the family-2 int8 logits are the CPU's")
    out["family2"] = {"launches": f2_launches, "logit_gap": gap2}

    # (d) the CLI: write, then load q.npz; --qat_steps on the card
    data = _image_folder(os.path.join(tmp, "i8_data"), INT8_CLI_PER_CLASS, seed=322,
                         split="train")
    _image_folder(data, INT8_CLI_PER_CLASS // 2, seed=323, split="test")
    cfg = os.path.join(tmp, "i8.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": F1_BATCH, "truncate_layer": F1_TRUNCATE, "dim": F1_DIM,
                   "seed": 0}, f)
    have_matplotlib = importlib.util.find_spec("matplotlib") is not None
    cli_q = os.path.join(tmp, "int8_cli_q.npz")

    def run(save, *extra):
        printed = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                cli(["--data", data, "--config_path", cfg, "--model_path",
                     os.path.join(tmp, "family1.npz"), "--mode", "classification",
                     "--save_dir", os.path.join(tmp, save), "--prob_threshold", "0",
                     "--precision", "int8", "--calib_data", data, "--device", DEVICE, *extra])
        except ModuleNotFoundError as e:  # confusion_matrix.png, after metrics.txt
            if have_matplotlib or e.name != "matplotlib":
                raise
        with open(os.path.join(tmp, save, "metrics.txt"), "rb") as f:
            return printed.getvalue(), f.read(), time.perf_counter() - t0

    kernels.reset_launch_counts()
    wrote, m1, s1 = run("i8_a", "--quantized_path", cli_q)
    loaded, m2, s2 = run("i8_b", "--quantized_path", cli_q)
    qat, _, s3 = run("i8_qat", "--qat_steps", "2", "--quantized_path",
                     os.path.join(tmp, "int8_cli_qat.npz"))
    cli_launches = kernels.launch_counts()
    qat_line = next((line for line in qat.splitlines() if line.startswith("QAT fine-tune")), "")
    print(f"[int8] CLI --precision int8: the first run ({s1:.1f} s) wrote q.npz "
          f"{'Quantised encoder saved' in wrote}, the second ({s2:.1f} s) loaded it "
          f"{'Quantised encoder saved' not in loaded}, metrics.txt byte-equal {m1 == m2}; "
          f"--qat_steps 2 ({s3:.1f} s): '{qat_line}'; launches {cli_launches}; matplotlib "
          f"{have_matplotlib}")
    _require("Quantised encoder saved" in wrote and "Quantised encoder saved" not in loaded
             and m1 == m2, "the CLI writes q.npz, then loads it to the same metrics")
    _require(qat_line.startswith("QAT fine-tune: 2 pas, perte "), "--qat_steps prints its line")
    _require(not any(cli_launches.values()), "the int8 CLI launches no hand-written kernel")
    out["cli"] = {"seconds": [s1, s2, s3], "metrics_equal": m1 == m2, "qat_line": qat_line}
    out["launches"] = {k: f2_launches[k] for k in f2_launches}
    return out


def _post_predict(url: str, img):
    """One raw POST to /predict: (status, JSON body, seconds on the host clock)."""
    req = urllib.request.Request(url + "/predict", data=img.tobytes(), method="POST",
                                 headers={"X-Raw-Shape": ",".join(map(str, img.shape))})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, json.loads(body), time.perf_counter() - t0


def _post_share(args):
    """A client process's share of a serve run: its frames POSTed from
    ``threads`` threads; the answers in order."""
    url, frames, threads = args
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(lambda f: _post_predict(url, f), frames))


def _serve_frames(seed: int, n: int, oversized_every: int):
    """``n`` random RGB uint8 frames, 224² but every ``oversized_every``-th
    300x400 (downscaled in submit)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, ((300, 400) if oversized_every and i % oversized_every == 0
                                 else (224, 224)) + (3,)).astype(np.uint8) for i in range(n)]


def _serve_run(kernels, clients, tag: str, argv: list, frames: list, precision: str) -> dict:
    """``cli/serve.start(argv)`` (its warmup included), then the frames as
    concurrent raw POSTs with the launch counts set to 0 just before and
    read just after; every answer against the direct batched forward (the
    batcher's own infer function, called here on the default stream) on
    the padded batch the dispatcher formed, which this run records; GET
    /healthz, /stats and /metrics."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli import serve
    from heuristique_style_transfer_code_tpu_torch.tasks.camera import rgb_to_yuv420
    from heuristique_style_transfer_code_tpu_torch.tasks.serving import prepare_frame

    args = serve.build_parser().parse_args(argv + ["--port", "0", "--device", DEVICE])
    t0 = time.perf_counter()
    srv, batcher = serve.start(args)
    start_s = time.perf_counter() - t0
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    warm = _serve_frames(339, SERVE_WARM, 0)  # the client processes' first requests, untimed
    list(clients.map(_post_share, [(url, warm[k::SERVE_CLIENT_PROCS], 4)
                                   for k in range(SERVE_CLIENT_PROCS)]))
    recorded = []
    launch = batcher._launch

    def recording(frames):  # the padded batch, as the dispatcher stacks it
        recorded.append(list(frames))
        return launch(frames)

    batcher._launch = recording
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        shares = list(clients.map(_post_share, [
            (url, frames[k::SERVE_CLIENT_PROCS], SERVE_CLIENTS // SERVE_CLIENT_PROCS)
            for k in range(SERVE_CLIENT_PROCS)]))
        wall = time.perf_counter() - t0
        answers = [shares[i % SERVE_CLIENT_PROCS][i // SERVE_CLIENT_PROCS]
                   for i in range(len(frames))]
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        health = _get(url, "/healthz")
        stats = json.loads(_get(url, "/stats")[1])
        metrics = _get(url, "/metrics")[1]
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop(drain=True)
    direct, outs = {}, []
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for padded in recorded:
            outs.append(batcher._infer(batcher._model,
                                       torch.from_numpy(np.stack(padded)).to(DEVICE)))
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3 / len(recorded)
        for padded, probs in zip(recorded, outs):
            probs = probs.cpu().numpy()
            for row, frame in enumerate(padded):
                direct.setdefault(frame.tobytes(), probs[row])
    gaps, argmax_equal, served = [], True, []
    for frame, (status, body, _) in zip(frames, answers):
        _require(status == 200, f"[serve] {tag}: a /predict answered {status}: {body}")
        key = prepare_frame(frame, 224)
        if args.transport == "yuv420":
            key = rgb_to_yuv420(key)
        want = direct[key.tobytes()]
        got = np.asarray(body["probs"], np.float32)
        gaps.append(float(np.abs(got - want).max()))
        argmax_equal &= int(got.argmax()) == int(want.argmax())
        served.append(got)
    lat = np.asarray([a[2] for a in answers]) * 1e3
    out = {"start_s": start_s, "requests": len(frames), "batches": len(recorded),
           "direct_batch_ms": batch_ms, "busy_share": len(recorded) * batch_ms / (wall * 1e3),
           "images_per_s": len(frames) / wall, "p50_ms": float(np.percentile(lat, 50)),
           "p95_ms": float(np.percentile(lat, 95)),
           "mean_occupancy": stats["mean_batch_occupancy"], "stats": stats,
           "max_gap": max(gaps), "argmax_equal": argmax_equal,
           "launches": {k: v for k, v in launches.items() if v}, "all_launches": launches}
    print(f"[serve] {tag}: start {start_s:.2f} s (warmup included); {len(frames)} POSTs from "
          f"{SERVE_CLIENTS} threads in {SERVE_CLIENT_PROCS} client processes, "
          f"{len(recorded)} batches of {SERVE_BATCH}: "
          f"{out['images_per_s']:.1f} images/s, p50 {out['p50_ms']:.2f} ms, p95 "
          f"{out['p95_ms']:.2f} ms (host clock, POST to JSON), mean occupancy "
          f"{out['mean_occupancy']:.3f}; a padded batch's direct forward {batch_ms:.2f} ms "
          f"(upload included, host clock after a synchronize), so the card busy about "
          f"{out['busy_share']:.2f} of the run; every answer vs the direct batched forward on its "
          f"padded batch: max |dprob| {out['max_gap']:.3e} (tol {SERVE_TOL[precision]}), "
          f"argmax equal {argmax_equal}; launches {out['launches']}; /healthz {health[0]}")
    _require(out["max_gap"] <= SERVE_TOL[precision] and argmax_equal,
             f"[serve] {tag}: every answer is the direct forward's")
    _require(health == (200, '{"ok": true}'), f"[serve] {tag}: /healthz {health}")
    served_n = len(frames) + SERVE_WARM + 1  # and the warmup's frame
    _require(stats["images"] == served_n, f"[serve] {tag}: /stats counts {stats}")
    _require(f"hst_images_total {served_n}\n" in metrics and "hst_healthy 1" in metrics
             and 'hst_latency_ms{quantile="0.95"}' in metrics, f"[serve] {tag}: /metrics")
    out["probs"] = np.stack(served)
    return out


def _serve_inputs(tmp: str):
    """The serve phase's configs and the family-3 train-variant checkpoint
    (config defaults, norm "instance"), written here, with the int8
    calibration folder and the --quantized_path it fills: (f1 config, f2
    config, f3 config, f3 checkpoint, calibration root, quantized path)."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import multiscale_init

    f1_cfg = os.path.join(tmp, "serve_f1.json")
    with open(f1_cfg, "w") as f:
        json.dump({"batch_size": F1_BATCH, "truncate_layer": F1_TRUNCATE, "dim": F1_DIM,
                   "seed": 0}, f)
    f2_cfg = os.path.join(tmp, "serve_f2.json")
    with open(f2_cfg, "w") as f:
        json.dump({"batch_size": F2_BATCH, "truncate_layer": 8, "gram_matrix_size": POOL_S,
                   "num_classes": 4}, f)
    cfg3 = MultiPatchGANConfig(norm="instance")
    f3_cfg, f3_ckpt = os.path.join(tmp, "serve_f3.json"), os.path.join(tmp, "serve_f3.npz")
    with open(f3_cfg, "w") as f:
        json.dump(cfg3.to_dict(), f)
    if not os.path.exists(f3_ckpt):
        save_pytree_npz(to_jax_tree(multiscale_init(
            torch.Generator().manual_seed(31), cfg3.patch_sizes, ndf=cfg3.ndf,
            num_classes=cfg3.num_classes, norm="instance", device="cpu")), f3_ckpt)
    cal = os.path.join(tmp, "serve_cal")
    if not os.path.isdir(cal):
        _image_folder(cal, SERVE_CAL_PER_CLASS, seed=330, split="train")
    return f1_cfg, f2_cfg, f3_cfg, f3_ckpt, cal, os.path.join(tmp, "serve_q.npz")


def _served_frames(server, frames) -> tuple:
    """Every frame through ``server`` from SD_THREADS client threads after
    one warm frame: (probabilities in order, seconds, batches, batches with
    the warm one)."""
    import numpy as np

    with server:
        server.submit(frames[0]).result(timeout=600)  # cuDNN's plans, the pinned buffers
        before = server.stats()["batches"]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SD_THREADS) as pool:
            futs = list(pool.map(server.submit, frames))
        probs = np.stack([f.result(timeout=600) for f in futs])
        seconds = time.perf_counter() - t0
        batches = server.stats()["batches"]
    return probs, seconds, batches - before, batches


def _serve_devices(kernels, tmp: str, f2_cfg: str, smi: str) -> dict:
    """``--devices`` on the server (see the module docstring's serve
    entry): family 2 through two replicas on card 0 in rgb and yuv420, and
    a 2-device artifact served on them, against one replica."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli import serve
    from heuristique_style_transfer_code_tpu_torch.core.mesh import DeviceGroup
    from heuristique_style_transfer_code_tpu_torch.deploy import artifact as dart
    from heuristique_style_transfer_code_tpu_torch.tasks.serving import BatchingInferenceServer

    t_piece = time.perf_counter()
    args = serve.build_parser().parse_args([
        "--family", "gram_attention", "--config_path", f2_cfg, "--model_path",
        os.path.join(tmp, "family2.npz"), "--batch_size", str(SERVE_BATCH), "--device", DEVICE])
    fwd, model, _, names = serve._resolve_forward(args)
    card = torch.device(DEVICE, 0)
    group = DeviceGroup([card, card])
    frames = _serve_frames(350, SD_FRAMES, 0)
    kw = dict(batch_size=SERVE_BATCH, max_delay_ms=50)
    out, launches = {}, 0
    t0 = time.perf_counter()
    blobs, meta = dart.export_infer_artifact(fwd, model, batch_size=SERVE_BATCH, mesh=group,
                                             class_names=names)
    path = os.path.join(tmp, "serve_devices_artifact.npz")
    dart.save_infer_artifact(path, blobs, meta)
    art = dart.load_infer_artifact(path, devices=group.devices)
    export_s = time.perf_counter() - t0
    _require(meta["n_devices"] == 2 and meta["batch_size"] == SERVE_BATCH,
             f"[serve] the 2-device artifact's meta: {meta}")
    cases = [("rgb", "rgb", dict(mesh=group)), ("yuv420", "yuv420", dict(mesh=group)),
             ("artifact_rgb", "rgb", dict(mesh=group, infer_fn=art.server_infer_fns()))]
    ones = {}
    for tag, transport, extra in cases:
        if transport not in ones:
            ones[transport] = _served_frames(BatchingInferenceServer(
                fwd, model, transport=transport, **kw), frames)
        one, one_s = ones[transport][:2]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        server = BatchingInferenceServer(None if "infer_fn" in extra else fwd,
                                         None if "infer_fn" in extra else model,
                                         transport=transport, device=card, **kw, **extra)
        got, seconds, batches, all_batches = _served_frames(server, frames)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        gap = float(abs(got - one).max())
        argmax = bool((got.argmax(1) == one.argmax(1)).all())
        want = {k: 0 for k in counts}
        want["pooled_gram_fwd"] = 4 * 2 * all_batches  # a forward a replica a batch
        print(f"[serve] devices {tag}: two replicas on {[str(d) for d in server.devices]}, "
              f"{len(frames)} frames in {batches} batches of {SERVE_BATCH} "
              f"({SERVE_BATCH // 2} rows a replica): every answer vs one replica's max |dprob| "
              f"{gap:.3e} (tol {SERVE_TOL['float32']}), argmax equal {argmax}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; {len(frames) / seconds:.1f} "
              f"images/s against one replica's {len(frames) / one_s:.1f} (both on one card: a "
              f"correctness cell, not a scaling one) ({smi})")
        _require(gap <= SERVE_TOL["float32"] and argmax,
                 f"[serve] devices {tag}: two replicas answer as one")
        _require(counts == want, f"[serve] devices {tag}: launches {counts} (want {want})")
        launches += counts["pooled_gram_fwd"]
        out[tag] = {"gap": gap, "argmax_equal": argmax, "batches": batches,
                    "images_per_s": len(frames) / seconds,
                    "one_replica_images_per_s": len(frames) / one_s, "launches": counts}
    out["artifact_export_and_load_s"] = export_s
    out["pooled_gram_fwd_launches"] = launches
    out["style"] = _serve_style_devices(kernels, tmp, f2_cfg, group, smi)
    out["piece_s"] = time.perf_counter() - t_piece
    print(f"[serve] devices piece {out['piece_s']:.2f} s (the 2-device artifact's export and "
          f"load {export_s:.2f} s)")
    return out


def _serve_style_devices(kernels, tmp: str, f2_cfg: str, group, smi: str) -> dict:
    """The style service's texture mode on the two replicas of ``group``,
    each replica's Gram program built by ``cli/serve_style``'s builder on
    its device (a model of its own), against one replica: SD_STYLE_BATCH
    jobs submitted in order (the same job ids, so the same noise)."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli import serve_style
    from heuristique_style_transfer_code_tpu_torch.tasks.style_service import (
        StyleTransferService,
    )

    args = serve_style.build_parser().parse_args([
        "--config_path", f2_cfg, "--model_path", os.path.join(tmp, "family2.npz"),
        "--layers", "5", "--device", DEVICE])
    images = list(np.random.RandomState(351).randint(
        0, 256, (SD_STYLE_BATCH, 224, 224, 3)).astype(np.uint8))

    def jobs(mesh):
        gram = (serve_style._build_gram_fn(args, group.devices[0]) if mesh is None
                else mesh.per_device(lambda d: serve_style._build_gram_fn(args, d)))
        service = StyleTransferService(gram, crop=224, batch_size=SD_STYLE_BATCH,
                                       num_iterations=SD_STYLE_ITERS, threshold=0.0,
                                       max_delay_ms=5000, seed=0, device=group.devices[0],
                                       mesh=mesh)
        with _deterministic_cudnn(), service:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            done = [f.result(timeout=600) for f in [service.submit(im) for im in images]]
            seconds = time.perf_counter() - t0
            torch.cuda.synchronize()
            return done, kernels.launch_counts(), seconds, service.devices

    one, one_counts, one_s, _ = jobs(None)
    two, counts, seconds, devices = jobs(group)
    loss_gap = max(abs(a.loss - b.loss) / abs(b.loss) for a, b in zip(two, one))
    px_gap = max(_u8_gap(a.image, b.image) for a, b in zip(two, one))
    iters = [r.iterations for r in two]
    want = {k: 2 * v for k, v in one_counts.items()}
    print(f"[serve] devices style: texture mode (family 2, layers 5) on two replicas on "
          f"{[str(d) for d in devices]}, {SD_STYLE_BATCH} jobs in one batch "
          f"({SD_STYLE_BATCH // 2} a replica), {SD_STYLE_ITERS} iterations, cuDNN's "
          f"deterministic algorithms: losses {[r.loss for r in two]} against one replica's "
          f"{[r.loss for r in one]}: {loss_gap:.2e} relative (tol {DPE_TOL}), pixels "
          f"{px_gap} uint8 levels (tol 1), iterations {iters} (one replica "
          f"{[r.iterations for r in one]}); launches { {k: v for k, v in counts.items() if v} } "
          f"(one replica { {k: v for k, v in one_counts.items() if v} }); {seconds:.2f} s "
          f"against one replica's {one_s:.2f} s (one card: a correctness cell) ({smi})")
    _require(loss_gap <= DPE_TOL and px_gap <= 1
             and iters == [r.iterations for r in one] == [SD_STYLE_ITERS] * SD_STYLE_BATCH,
             "[serve] devices style: two replicas answer as one")
    _require(counts == want and want["gram_fwd"] > 0 and want["gram_bwd"] > 0,
             f"[serve] devices style: launches {counts} (want twice one replica's, {want})")
    return {"loss_gap": loss_gap, "pixel_gap": px_gap, "iterations": iters,
            "launches": counts, "one_replica_launches": one_counts, "seconds": seconds,
            "one_replica_seconds": one_s}


def phase_serve(kernels, tmp: str, timings: dict, smi: str) -> dict:
    """``cli/serve.start`` at full width, --batch_size 64: family 1 (its
    default config through the family1 phase's npz) in f32, bf16, int8
    (calibrated on a small ImageFolder and written to --quantized_path,
    then a second start from that file alone) and yuv420; family 2
    (truncate 8, S 7) and family 3 (the train variant the JAX CLI serves,
    config defaults, norm "instance") in f32. Each run answers
    SERVE_REQUESTS concurrent POSTs (``_serve_run``). Family 1 launches no
    hand-written kernel, family 2 four ``pooled_gram_fwd`` a batch, family
    3 thirteen ``instance_norm_fwd`` a batch (its train variant has no
    Gram)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    f1_cfg, f2_cfg, f3_cfg, f3_ckpt, cal, qpath = _serve_inputs(tmp)
    f1 = ["--family", "truncated_resnet50", "--config_path", f1_cfg, "--model_path",
          os.path.join(tmp, "family1.npz"), "--batch_size", str(SERVE_BATCH)]
    runs = [
        ("family1_float32", f1, "float32"),
        ("family1_bf16", f1 + ["--precision", "bf16"], "bf16"),
        ("family1_int8", f1 + ["--precision", "int8", "--calib_data", cal, "--quantized_path",
                               qpath], "int8"),
        ("family1_int8_from_quantized_path", f1 + ["--precision", "int8", "--quantized_path",
                                                   qpath], "int8"),
        ("family1_yuv420", f1 + ["--transport", "yuv420"], "float32"),
        ("family2_float32", ["--family", "gram_attention", "--config_path", f2_cfg,
                             "--model_path", os.path.join(tmp, "family2.npz"),
                             "--batch_size", str(SERVE_BATCH)], "float32"),
        ("family3_instance_float32", ["--family", "multi_patchgan", "--config_path", f3_cfg,
                                      "--model_path", f3_ckpt, "--batch_size",
                                      str(SERVE_BATCH)], "float32"),
    ]
    out = {}
    clients = ProcessPoolExecutor(SERVE_CLIENT_PROCS, mp_context=multiprocessing.get_context(
        "spawn"))
    clients.submit(time.sleep, 0).result()  # the client processes up before any run
    try:
        for i, (tag, argv, precision) in enumerate(runs):
            frames = _serve_frames(340 + (i if "from_quantized" not in tag else i - 1),
                                   SERVE_REQUESTS, SERVE_OVERSIZED)
            out[tag] = _serve_run(kernels, clients, tag, argv, frames, precision)
    finally:
        clients.shutdown()
    for tag, res in out.items():
        batches, launches = res["batches"], res["all_launches"]
        want = {k: 0 for k in launches}
        if tag.startswith("family2"):
            want["pooled_gram_fwd"] = 4 * batches
        elif tag.startswith("family3"):
            want["instance_norm_fwd"] = len(F3T_IN_SHAPES) * batches
        _require(launches == want, f"[serve] {tag}: launches {want}: {launches}")
        timings[f"serve_{tag}_images_per_s"] = res["images_per_s"]
    _require(os.path.exists(qpath), "[serve] the int8 run wrote --quantized_path")
    same = float(np.abs(out["family1_int8"]["probs"]
                        - out["family1_int8_from_quantized_path"]["probs"]).max())
    print(f"[serve] family 1 int8 from --quantized_path alone vs the calibrating run on the "
          f"same frames: max |dprob| {same:.3e}")
    _require(same <= SERVE_TOL["int8"], "the int8 server from --quantized_path answers alike")
    for res in out.values():
        res.pop("probs")
    out["devices"] = _serve_devices(kernels, tmp, f2_cfg, smi)
    style = out["devices"]["style"]  # the style service, two replicas and one
    out["launches"] = {"pooled_gram_fwd": out["family2_float32"]["all_launches"][
        "pooled_gram_fwd"] + out["devices"]["pooled_gram_fwd_launches"],
        "instance_norm_fwd": out["family3_instance_float32"]["all_launches"][
        "instance_norm_fwd"],
        **{k: style["launches"][k] + style["one_replica_launches"][k]
           for k in ("gram_fwd", "gram_bwd")}}
    return out


def _timed_handovers(proxy) -> list:
    """Each handover of ``proxy`` from then on: whether it was a recycle,
    whether it was the last worker's exit at stop, its seconds (the old
    worker joined, the new one spawned and ready), the spawn's seconds and
    the new worker's builder seconds (``build_s`` of its ready info)."""
    handovers = []
    gone, spawn = proxy._on_child_gone, proxy._spawn

    def timed_spawn():
        t0 = time.perf_counter()
        spawn()
        handovers[-1]["spawn_s"] = time.perf_counter() - t0
        handovers[-1]["build_s"] = proxy.info.get("build_s")

    def timed(expected):
        handovers.append({"recycle": expected, "final": proxy._stopping})
        t0 = time.perf_counter()
        gone(expected)
        handovers[-1]["seconds"] = time.perf_counter() - t0

    proxy._on_child_gone, proxy._spawn = timed, timed_spawn
    return handovers


def _recycle_serve_style(spec: dict, out: dict) -> None:
    """``serve_style --recycle_after_requests 2`` in texture mode: 3 POSTs
    through one recycle (a thread of ``_recycle_parent``)."""
    import numpy as np

    from heuristique_style_transfer_code_tpu_torch.cli import serve_style
    from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

    try:
        argv = spec["style_argv"]
        srv, proxy = serve_style.start_recycling(serve_style.build_parser().parse_args(argv),
                                                 argv)
        out["first_build_s"] = proxy.info.get("build_s")
        handovers = _timed_handovers(proxy)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            styled, statuses = [], []
            for canvas in np.load(spec["canvases"]):
                status, png, headers = _post_raw(url, canvas)
                statuses.append([status, headers.get("X-Iterations")])
                styled.append(decode_png(png))
            stats = proxy.stats()
        finally:
            srv.shutdown()
            srv.server_close()
            proxy.stop(drain=True)
        np.save(spec["styled_out"], np.stack(styled))
        out.update(statuses=statuses, stats=stats, handovers=handovers)
    except Exception as e:  # reported by the phase, which fails on it
        out["error"] = f"{type(e).__name__}: {e}"


def _recycle_parent(spec_path: str) -> int:
    """The recycling proxy's parent, run as a child process of this script
    (``--recycle-parent SPEC``): it never touches the card. Serves family 1
    through ``cli/serve.start_recycling`` and POSTs the spec's frames from
    RECYCLE_CLIENTS threads, killing the worker once RECYCLE_KILL_AFTER
    answers are in while requests are in it (the spec's ``kill_after``, None
    for no kill); meanwhile, on a thread, ``serve_style
    --recycle_after_requests`` in texture mode (``_recycle_serve_style``;
    not where the spec has no ``style_argv``). Writes the answers, the stats, each
    handover's seconds and ``torch.cuda.is_initialized()`` to the spec's
    output."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli import serve

    with open(spec_path) as f:
        spec = json.load(f)
    frames = np.load(spec["frames"])
    style = {}
    style_thread = threading.Thread(target=_recycle_serve_style, args=(spec, style))
    if spec.get("style_argv"):
        style_thread.start()
    kill_after = spec.get("kill_after", RECYCLE_KILL_AFTER)

    argv = spec["serve_argv"]
    t0 = time.perf_counter()
    srv, proxy = serve.start_recycling(serve.build_parser().parse_args(argv), argv)
    first_start = time.perf_counter() - t0
    first_build = proxy.info.get("build_s")
    handovers = _timed_handovers(proxy)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    done, killed = [0], {}
    lock = threading.Lock()

    def post(i):
        res = _post_predict(url, frames[i])
        with lock:
            done[0] += 1
        return res

    def killer():
        while kill_after is not None and not killed and done[0] < len(frames):
            with proxy._lock:
                proc, in_worker = proxy._proc, proxy._in_worker
            if done[0] >= kill_after and proc is not None and in_worker > 0:
                proc.kill()
                killed.update(pid=proc.pid, in_worker=in_worker, after=done[0])
                return
            time.sleep(0.002)

    try:
        watcher = threading.Thread(target=killer, daemon=True)
        watcher.start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(RECYCLE_CLIENTS) as pool:
            answers = list(pool.map(post, range(len(frames))))
        wall = time.perf_counter() - t0
        watcher.join(5)
        stats = proxy.stats()
        health = _get(url, "/healthz")
    finally:
        srv.shutdown()
        srv.server_close()
        proxy.stop(drain=True)
    if spec.get("style_argv"):
        style_thread.join()
    lat = np.asarray([a[2] for a in answers]) * 1e3
    result = {"serve": {
        "statuses": [a[0] for a in answers], "stats": stats, "handovers": handovers,
        "killed": killed, "first_start_s": first_start, "first_build_s": first_build,
        "images_per_s": len(frames) / wall, "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)), "healthz": list(health)},
        "serve_style": style, "cuda_initialized_in_parent": torch.cuda.is_initialized()}
    np.save(spec["probs_out"], np.stack([np.asarray(a[1].get("probs", [np.nan] * 4), np.float32)
                                         for a in answers]))
    with open(spec["out"], "w") as f:
        json.dump(result, f)
    return 0


def phase_recycle(kernels, tmp: str, timings: dict) -> dict:
    """``--recycle_after_requests`` on both serve CLIs. The proxy's parent
    is a child process of this script (``_recycle_parent``), which must
    never initialise CUDA. (a) Family 1 f32 at batch RECYCLE_BATCH with
    --recycle_after_requests RECYCLE_AFTER under RECYCLE_REQUESTS
    concurrent POSTs: at least two recycles, the worker killed once with
    requests in it (replayed), no failed request, every answer within 1e-5
    of in-process serving (``cli/serve.start`` here, the same argv without
    the flag). (b) ``serve_style`` texture mode (family 2, layers 5,
    RECYCLE_STYLE_ITERS iterations, batch 2, crop 224, the CLI's only one)
    with --recycle_after_requests 2 over 3 POSTs: one recycle, each answer
    against the service's job run here on its canvas and job id (ids start
    again at 0 in each worker), all within Adam's 2·lr·iterations in
    uint8, 99% within one step."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli import serve, serve_style

    f1 = ["--family", "truncated_resnet50", "--config_path", os.path.join(tmp, "serve_f1.json"),
          "--model_path", os.path.join(tmp, "family1.npz"), "--batch_size",
          str(RECYCLE_BATCH), "--device", DEVICE]
    frames = np.stack(_serve_frames(360, RECYCLE_REQUESTS, 0))
    f2_cfg = os.path.join(tmp, "serve_f2.json")
    style = ["--config_path", f2_cfg, "--model_path", os.path.join(tmp, "family2.npz"),
             "--layers", "5", "--num_iterations", str(RECYCLE_STYLE_ITERS), "--threshold",
             "0", "--lr", str(RECYCLE_STYLE_LR), "--batch_size", "2", "--max_delay_ms", "5",
             "--device", DEVICE]
    canvases = np.random.RandomState(361).randint(0, 256, (3, 224, 224, 3)).astype(np.uint8)
    paths = {k: os.path.join(tmp, f"recycle_{k}") for k in
             ("frames.npy", "canvases.npy", "probs.npy", "styled.npy", "out.json", "spec.json")}
    np.save(paths["frames.npy"], frames)
    np.save(paths["canvases.npy"], canvases)
    spec = {"frames": paths["frames.npy"], "canvases": paths["canvases.npy"],
            "probs_out": paths["probs.npy"], "styled_out": paths["styled.npy"],
            "out": paths["out.json"],
            "serve_argv": f1 + ["--port", "0", "--recycle_after_requests", str(RECYCLE_AFTER),
                                "--request_timeout", str(RECYCLE_TIMEOUT_S)],
            "style_argv": style + ["--port", "0", "--recycle_after_requests", "2"]}
    with open(paths["spec.json"], "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--recycle-parent",
                           paths["spec.json"]], capture_output=True, text=True, timeout=600)
    parent_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:], file=sys.stderr)
    _require(proc.returncode == 0, f"the recycling parent exited {proc.returncode}")
    with open(paths["out.json"]) as f:
        res = json.load(f)
    probs = np.load(paths["probs.npy"])

    # (a) against in-process serving of the same frames
    args = serve.build_parser().parse_args(f1 + ["--port", "0"])
    srv, batcher = serve.start(args)
    try:
        want = np.stack([f.result(timeout=600) for f in [batcher.submit(x) for x in frames]])
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop(drain=True)
    a = res["serve"]
    gap = float(np.abs(probs - want).max())
    failed = sum(st != 200 for st in a["statuses"])
    recycles = [h for h in a["handovers"] if h["recycle"] and not h["final"]]
    crashes = [h for h in a["handovers"] if not h["recycle"]]

    def seconds(hs):
        return [f"{h['seconds']:.2f} (spawn {h['spawn_s']:.2f}, builder {h['build_s']:.2f})"
                for h in hs]

    print(f"[recycle] serve family 1 f32, b{RECYCLE_BATCH}, --recycle_after_requests "
          f"{RECYCLE_AFTER}: {RECYCLE_REQUESTS} POSTs from {RECYCLE_CLIENTS} threads, "
          f"{failed} failed; {a['stats']['recycles']} recycles, "
          f"{a['stats']['worker_crashes']} crash (killed {a['killed']}); handovers (the old "
          f"worker joined to the new one ready, s) {seconds(recycles)}, after the kill "
          f"{seconds(crashes)}; first start {a['first_start_s']:.2f} s (builder "
          f"{a['first_build_s']:.2f}); "
          f"{a['images_per_s']:.1f} images/s, p50 {a['p50_ms']:.1f} ms, p95 {a['p95_ms']:.1f} ms "
          f"(host clock, handovers included); vs in-process serving: max |dprob| {gap:.3e} "
          f"(tol {SERVE_TOL['float32']}); CUDA initialised in the parent: "
          f"{res['cuda_initialized_in_parent']}; the parent's process {parent_s:.1f} s")
    _require(failed == 0 and a["stats"]["recycles"] >= 2 and a["stats"]["worker_crashes"] == 1
             and a["stats"]["pending"] == 0, f"[recycle] no failure, >= 2 recycles, 1 crash: "
             f"{a['stats']}")
    _require(a["killed"].get("in_worker", 0) > 0, "[recycle] the killed worker held requests")
    _require(gap <= SERVE_TOL["float32"] and np.array_equal(probs.argmax(1), want.argmax(1)),
             "[recycle] the recycled answers are in-process serving's")
    _require(res["cuda_initialized_in_parent"] is False, "the proxy's parent never used CUDA")

    # (b) serve_style texture mode through one recycle
    b = res["serve_style"]
    _require("error" not in b, f"[recycle] serve_style's recycling: {b.get('error')}")
    styled = np.load(paths["styled.npy"])
    service = serve_style.build_service(serve_style.build_parser().parse_args(style))
    ids = [(0, 1), (0,)]  # the first worker's two jobs, the second worker's one
    expected = []
    for group, batch in ((ids[0], canvases[:2]), (ids[1], canvases[2:])):
        pad = np.concatenate([batch, batch[:1]])[:2]
        job_ids = np.asarray(list(group) + [group[0]], np.int32)[:2]
        pixels = service._jobs_by_size[2](pad, np.zeros((2, 1), np.float32), job_ids)[0]
        expected += list(pixels.cpu().numpy()[: len(group)])
    diffs = np.abs(styled.astype(np.int16) - np.stack(expected).astype(np.int16))
    bound = int(np.ceil(2 * RECYCLE_STYLE_LR * RECYCLE_STYLE_ITERS * 0.229 * 255))
    within_one = float((diffs <= 1).mean())
    print(f"[recycle] serve_style texture (layers 5, {RECYCLE_STYLE_ITERS} iterations, b2), "
          f"--recycle_after_requests 2, 3 POSTs: statuses {b['statuses']}, "
          f"{b['stats']['recycles']} recycle, handover "
          f"{seconds([h for h in b['handovers'] if not h['final']])} s (run beside (a)); vs the "
          f"job run here: max "
          f"{int(diffs.max())} uint8 steps (Adam's bound {bound}), {within_one:.4f} within one")
    _require(all(st == [200, str(RECYCLE_STYLE_ITERS)] for st in b["statuses"])
             and b["stats"]["recycles"] == 1 and b["stats"]["worker_crashes"] == 0,
             f"[recycle] serve_style through one recycle: {b}")
    _require(int(diffs.max()) <= bound and within_one >= 0.99,
             "[recycle] serve_style's recycled answers are the service's jobs")
    del service
    torch.cuda.synchronize()
    timings["recycle_handover_s"] = [h["seconds"] for h in recycles]
    return {"serve": {k: a[k] for k in ("stats", "handovers", "killed", "first_start_s",
                                         "first_build_s", "images_per_s", "p50_ms", "p95_ms")},
            "max_gap": gap, "serve_style": b, "serve_style_max_u8_gap": int(diffs.max()),
            "parent_seconds": parent_s,
            "cuda_initialized_in_parent": res["cuda_initialized_in_parent"]}


def _host_us_per_call(fn, calls: int = ART_OVERHEAD_CALLS) -> float:
    """Host microseconds a call of ``fn`` (a launch of a small kernel, so the
    host, not the card, sets the pace), after a warm-up; synchronised only
    before and after."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def _op_overhead(kg, kin) -> dict:
    """Host us a call of ``gram_fwd`` at (1,4,4,64) and of
    ``instance_norm_fwd`` at (1,112,112,64), f32, through the
    ``torch.library`` op, through the direct wrapper, and (where a gradient
    flows) through the differentiable shim."""
    import torch

    f = torch.rand((1, 16, 64), device=DEVICE)
    fg = f.clone().requires_grad_(True)
    x = torch.randn((1, 112 * 112, 64), device=DEVICE)
    xg = x.clone().requires_grad_(True)
    ones, zeros = torch.ones((1, 64), device=DEVICE), torch.zeros((1, 64), device=DEVICE)
    out = {
        "gram_fwd_op_us": _host_us_per_call(lambda: torch.ops.hst.gram_fwd.default(f)),
        "gram_fwd_wrapper_us": _host_us_per_call(lambda: kg.gram_fwd(f)),
        "gram_fwd_op_with_grad_us": _host_us_per_call(lambda: kg.GramFunction.apply(fg)),
        "instance_norm_fwd_op_us": _host_us_per_call(
            lambda: torch.ops.hst.instance_norm_fwd.default(x, ones, zeros, kin.EPS, True)),
        "instance_norm_fwd_wrapper_us": _host_us_per_call(
            lambda: kin.instance_norm_fwd(x, ones, zeros, kin.EPS, True)),
        "instance_norm_fwd_op_with_grad_us": _host_us_per_call(
            lambda: kin.InstanceNormFunction.apply(xg, ones, zeros, kin.EPS, True)),
    }
    with torch.inference_mode():  # as evaluation, the camera and the servers call them
        out.update({
            "gram_fwd_op_inference_us": _host_us_per_call(
                lambda: torch.ops.hst.gram_fwd.default(f)),
            "gram_fwd_wrapper_inference_us": _host_us_per_call(lambda: kg.gram_fwd(f)),
            "instance_norm_fwd_op_inference_us": _host_us_per_call(
                lambda: torch.ops.hst.instance_norm_fwd.default(x, ones, zeros, kin.EPS, True)),
            "instance_norm_fwd_wrapper_inference_us": _host_us_per_call(
                lambda: kin.instance_norm_fwd(x, ones, zeros, kin.EPS, True)),
        })
    print(f"[artifact] host us a call (f32, {ART_OVERHEAD_CALLS} calls): gram_fwd (1,4,4,64) "
          f"op {out['gram_fwd_op_us']:.2f}, wrapper {out['gram_fwd_wrapper_us']:.2f}, op with "
          f"a gradient to flow {out['gram_fwd_op_with_grad_us']:.2f}; instance_norm_fwd "
          f"(1,112,112,64) ReLU op {out['instance_norm_fwd_op_us']:.2f}, wrapper "
          f"{out['instance_norm_fwd_wrapper_us']:.2f}, op with a gradient to flow "
          f"{out['instance_norm_fwd_op_with_grad_us']:.2f}; under inference_mode gram_fwd op "
          f"{out['gram_fwd_op_inference_us']:.2f}, wrapper "
          f"{out['gram_fwd_wrapper_inference_us']:.2f}, instance_norm_fwd op "
          f"{out['instance_norm_fwd_op_inference_us']:.2f}, wrapper "
          f"{out['instance_norm_fwd_wrapper_inference_us']:.2f}")
    return out


def _hst_nodes(ep) -> list:
    return sorted({str(n.target) for n in ep.graph.nodes if str(n.target).startswith("hst.")})


def _export_all(jobs: dict, tmp: str) -> dict:
    """``python -m <PKG>.cli.<module> <argv> --export_artifact <path>`` for
    each ``tag: (module, argv, path)`` of ``jobs``, each in a process of
    its own on the card, all at once (each export is a host-bound trace);
    returns each one's wall seconds, its interpreter's start included. A
    failed or late export raises, and every process is stopped."""
    t0 = time.perf_counter()
    procs, seconds = {}, {}
    try:
        for tag, (module, argv, path) in jobs.items():
            log = open(os.path.join(tmp, f"export_{tag}.log"), "w")
            procs[tag] = (subprocess.Popen(
                [sys.executable, "-m", f"{PKG}.cli.{module}", *argv, "--export_artifact", path,
                 "--device", DEVICE], cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log)
        while len(seconds) < len(procs):
            _require(time.perf_counter() - t0 < ART_EXPORT_TIMEOUT_S,
                     f"[artifact] exports still running after {ART_EXPORT_TIMEOUT_S} s")
            for tag, (proc, log) in procs.items():
                if tag not in seconds and proc.poll() is not None:
                    seconds[tag] = time.perf_counter() - t0
                    log.close()
                    if proc.returncode:
                        with open(log.name) as f:
                            print(f.read()[-4000:], file=sys.stderr)
                    _require(proc.returncode == 0,
                             f"[artifact] the {tag} export exited {proc.returncode}")
            time.sleep(0.2)
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    print(f"[artifact] {len(jobs)} exports side by side in {max(seconds.values()):.2f} s: "
          + ", ".join(f"{tag} {sec:.2f}" for tag, sec in seconds.items()))
    return seconds


def _artifact_infer(kernels, tag: str, argv: list, precision: str, path: str, export_s: float,
                    per_forward: dict) -> dict:
    """The file ``serve --export_artifact`` of ``argv`` wrote at ``path``,
    loaded back, and at each of ART_BATCHES its probabilities against the
    live infer function the batcher builds (``make_camera_infer_fn``) on
    the same batch, with the launches of a forward (``per_forward`` a
    forward, every other kernel none) and the graph's ``hst`` nodes."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli import serve
    from heuristique_style_transfer_code_tpu_torch.deploy import load_infer_artifact
    from heuristique_style_transfer_code_tpu_torch.tasks.camera import (
        make_camera_infer_fn,
        make_camera_infer_fn_yuv,
    )

    t0 = time.perf_counter()
    art = load_infer_artifact(path)
    load_s = time.perf_counter() - t0
    args = serve.build_parser().parse_args(argv + ["--device", DEVICE])
    fwd, model, _, _ = serve._resolve_forward(args)
    tail = (224 * 3 // 2, 224) if args.transport == "yuv420" else (224, 224, 3)
    rows = []
    for n in ART_BATCHES:
        live_fn = (make_camera_infer_fn_yuv(fwd, 224, batch=n) if args.transport == "yuv420"
                   else make_camera_infer_fn(fwd, batch=n, host_downscale=True))
        x = torch.from_numpy(np.random.RandomState(n).randint(0, 256, (n,) + tail).astype(
            np.uint8)).to(DEVICE)
        live = live_fn(model, x)
        again = live_fn(model, x)  # the live path's own run-to-run spread
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with torch.inference_mode():
            got = art(x)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        rows.append({"batch": n, "max_gap": float((got - live).abs().max()),
                     "bit_equal": bool(torch.equal(got, live)),
                     "live_twice_bit_equal": bool(torch.equal(again, live)),
                     "shape": list(got.shape),
                     "launches": {k: v for k, v in launches.items() if v}})
        if n == ART_BATCHES[-1]:  # host ms to issue a forward, and with its sync
            with torch.inference_mode():
                for side, call in (("live", lambda: live_fn(model, x)), ("artifact",
                                                                     lambda: art(x))):
                    host, wall = [], []
                    for _ in range(6):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        call()
                        host.append(time.perf_counter() - t0)
                        torch.cuda.synchronize()
                        wall.append(time.perf_counter() - t0)
                    rows[-1][f"{side}_host_ms"] = float(np.median(host[1:]) * 1e3)
                    rows[-1][f"{side}_wall_ms"] = float(np.median(wall[1:]) * 1e3)
        want = {k: 0 for k in launches}
        want.update(per_forward)
        _require(tuple(got.shape) == (n, 4), f"[artifact] {tag} b{n}: shape {tuple(got.shape)}")
        _require(launches == want, f"[artifact] {tag} b{n}: launches {want}: {launches}")
    nodes = _hst_nodes(art.exported)
    out = {"export_s": export_s, "load_s": load_s, "bytes": os.path.getsize(path),
           "meta": art.meta, "hst_nodes": nodes, "rows": rows, "path": path}
    last = rows[-1]
    print(f"[artifact] {tag}: export process {export_s:.2f} s, {out['bytes'] / 1e6:.1f} MB, loaded "
          f"in {load_s:.2f} s; b{last['batch']} host ms to issue a forward live "
          f"{last['live_host_ms']:.2f} artifact {last['artifact_host_ms']:.2f}, with its sync "
          f"{last['live_wall_ms']:.2f} and {last['artifact_wall_ms']:.2f}; "
          f"hst nodes {nodes}; vs the live infer function on the same batch: "
          + ", ".join(f"b{r['batch']} max |dprob| {r['max_gap']:.3e} (bit-equal "
                      f"{r['bit_equal']}; two live runs bit-equal {r['live_twice_bit_equal']}; "
                      f"launches {r['launches']})" for r in rows))
    _require(all(r["max_gap"] <= SERVE_TOL[precision] for r in rows),
             f"[artifact] {tag}: the artifact answers as the live forward (tol "
             f"{SERVE_TOL[precision]})")
    _require(set(nodes) == {f"hst.{k}.default" for k in per_forward},
             f"[artifact] {tag}: the graph's hst nodes {nodes}")
    return out


def _style_jobs(kernels, services, batch: int, canvases, w, ids, res: dict) -> None:
    """The batch-``batch`` job of each (name, service) on the same inputs,
    after a warm run (cuDNN's choices): its uint8 canvases, iterations,
    per-image losses, seconds (host clock, synchronised) and launches into
    ``res[name]``."""
    import torch

    for side, service in services:
        service._jobs_by_size[batch](canvases, w, ids)[0].cpu()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        u8, iters, per = service._jobs_by_size[batch](canvases, w, ids)
        u8 = u8.cpu().numpy()
        res[side] = {"u8": u8, "iters": int(iters), "loss": torch.as_tensor(per).cpu().numpy(),
                     "job_s": time.perf_counter() - t0, "launches": kernels.launch_counts()}


def _iteration_host(service, canvases, w, ids) -> dict:
    """Host ms to issue one iteration of ``service``'s live loop
    (``masked_adam_step`` on its loss, nothing synchronised inside) and
    with its sync: medians over ART_STYLE_ITERS iterations after a warm
    one."""
    import functools

    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.tasks.style_service import job_noises
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        bias_corrections,
        masked_adam_step,
    )

    loop = service.loop
    noise = ((job_noises(loop.seed, ids, canvases.shape[1:], DEVICE),) if loop.noise else ())
    pixels, *rest = loop.prepare(torch.from_numpy(canvases).to(DEVICE),
                                 torch.from_numpy(w).to(DEVICE), *noise)
    step = functools.partial(masked_adam_step, loop.loss, loop.learning_rate, loop.threshold)
    state = (pixels.float(), torch.zeros_like(pixels), torch.zeros_like(pixels),
             torch.ones((len(ids),), dtype=torch.bool, device=DEVICE))
    host, wall = [], []
    for i in range(ART_STYLE_ITERS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(*state, *bias_corrections(i + 1), *rest)[:4]
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i:
            host.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
    return {"host_ms": float(np.median(host) * 1e3), "wall_ms": float(np.median(wall) * 1e3)}


def _artifact_style(kernels, tag: str, argv: list, path: str, export_s: float, batch: int,
                    styles: int, iteration_host: bool = False, net: bool = False) -> dict:
    """The file ``serve_style --export_artifact`` of ``argv`` wrote at
    ``path``, and the service built from ``--artifact`` beside the one
    built from ``argv``: the batch-``batch`` job of both on
    the same canvases, blend rows and job ids, under cuDNN's deterministic
    algorithms, with their launches, the iterations, the per-image losses
    and the uint8 canvases compared (and the live job's own run-to-run
    spread beside them), each job timed (host clock, synchronised); with
    ``iteration_host``, ``_iteration_host`` of the live loop. A ``net``
    job (the fast-style net: one forward, no loop) is held bit for bit
    with NORMS_PER_FORWARD instance_norm_fwd launches."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli import serve_style

    live = serve_style.build_service(serve_style.build_parser().parse_args(
        argv + ["--device", DEVICE]))
    t0 = time.perf_counter()
    served = serve_style.build_service(serve_style.build_parser().parse_args(
        argv + ["--artifact", path, "--device", DEVICE]))
    load_s = time.perf_counter() - t0
    canvases = np.random.RandomState(370).randint(0, 256, (batch, 224, 224, 3)).astype(np.uint8)
    w = np.zeros((batch, styles), np.float32)
    w[np.arange(batch), np.arange(batch) % styles] = 1.0
    ids = np.arange(batch, dtype=np.int32)
    res = {}
    # cuDNN's deterministic algorithms for the comparison: the default ones
    # may sum a backward in another order from one run to the next (the
    # content+style loop's losses then differ by ~2e-5 between two live runs)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _style_jobs(kernels, (("live", live), ("artifact", served), ("live_again", live)),
                    batch, canvases, w, ids, res)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b, again = res["live"], res["artifact"], res["live_again"]

    def rel(x, y):
        return float(np.abs(x - y).max() / max(np.abs(x).max(), 1e-30))

    gap = _u8_gap(a["u8"], b["u8"])
    loss_rel, live_rel = rel(a["loss"], b["loss"]), rel(a["loss"], again["loss"])
    from heuristique_style_transfer_code_tpu_torch.deploy.artifact import load_style_artifact

    nodes = {name: _hst_nodes(ep)
             for name, ep in load_style_artifact(path).exported_by_size[batch].items()}
    out = {"export_s": export_s, "load_s": load_s, "bytes": os.path.getsize(path),
           "iterations": [a["iters"], b["iters"]], "max_u8_gap": gap, "loss_rel_gap": loss_rel,
           "launches": {k: v for k, v in b["launches"].items() if v},
           "live_launches": {k: v for k, v in a["launches"].items() if v},
           "job_s": {"live": a["job_s"], "artifact": b["job_s"], "live_again": again["job_s"]},
           "live_loss_rel_spread": live_rel, "live_u8_spread": _u8_gap(a["u8"], again["u8"]),
           "hst_nodes": nodes, "path": path}
    if iteration_host:
        out["iteration"] = _iteration_host(live, canvases, w, ids)
    print(f"[artifact] serve_style {tag} b{batch}: export process {export_s:.2f} s, "
          f"{out['bytes'] / 1e6:.1f} MB, served from the file in {load_s:.2f} s; iterations "
          f"{out['iterations']}, max uint8 gap {gap}, loss rel gap {loss_rel:.2e} (two live "
          f"runs: {out['live_u8_spread']} and {live_rel:.2e}); launches artifact "
          f"{out['launches']} live {out['live_launches']}; job s live {a['job_s']:.3f} "
          f"(again {again['job_s']:.3f}) artifact {b['job_s']:.3f}; hst nodes {nodes}"
          + (f"; a live iteration: host {out['iteration']['host_ms']:.2f} ms to issue, "
             f"{out['iteration']['wall_ms']:.2f} ms with its sync" if iteration_host else ""))
    if net:
        _require(a["iters"] == b["iters"] and gap == 0 and np.array_equal(a["u8"], b["u8"]),
                 f"[artifact] serve_style {tag}: the artifact's job is the live net job's, bit "
                 f"for bit")
        _require(a["launches"] == b["launches"]
                 and b["launches"]["instance_norm_fwd"] == NORMS_PER_FORWARD,
                 f"[artifact] serve_style {tag}: {NORMS_PER_FORWARD} instance_norm_fwd a "
                 f"forward, as the live job's: {b['launches']}")
        return out
    _require(a["iters"] == b["iters"] and gap <= 1 and loss_rel <= max(ART_STYLE_LOSS_RTOL,
                                                                      2 * live_rel),
             f"[artifact] serve_style {tag}: the artifact's job is the live service's")
    _require(a["launches"] == b["launches"] and b["launches"]["gram_fwd"] > 0
             and b["launches"]["gram_bwd"] > 0,
             f"[artifact] serve_style {tag}: launches equal to the live service's")
    return out


def phase_artifact(kernels, kg, kin, tmp: str, timings: dict, serving=None,
                   recycle=None) -> dict:
    """Serving artifacts (``deploy/artifact.py``) on the card. The host cost
    of the ``torch.library`` ops (``_op_overhead``); every export through
    the CLIs, side by side (``_export_all``); each ``serve
    --export_artifact`` file loaded back, at b1, b7 and b64 against the
    live forward (``_artifact_infer``): family 1
    in f32 (symbolic batch), bf16, int8 (from --quantized_path) and
    yuv420, family 2 and family 3 (norm "instance") in f32; ``serve
    --artifact`` (family 2) under SERVE_REQUESTS concurrent POSTs, every
    answer against the direct forward, beside the serve phase's family-2
    run; ``--recycle_after_requests`` with ``--artifact`` (family 1, b16,
    one recycle, in a child process beside the style checks that follow),
    its handover beside the recycle phase's; ``serve_style
    --export_artifact`` and ``--artifact`` for texture mode (family 2,
    layers 5, b2), family 3 (norm "instance", b1, with a live iteration's
    host time), content+style (b2) and the fast-style net (``--net``, the
    fast_style phase's seeded net, b8: bit for bit, 15 instance_norm_fwd a
    forward), one POST through the texture artifact's server."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.tasks.camera import make_camera_infer_fn
    from heuristique_style_transfer_code_tpu_torch.tasks.serving import prepare_frame

    t_phase = time.perf_counter()
    out = {"overhead": _op_overhead(kg, kin)}
    f1_cfg, f2_cfg, f3_cfg, f3_ckpt, cal, qpath = _serve_inputs(tmp)
    for name, make in (("family1.npz", lambda: _family1(tmp)),
                       ("family3_instance.npz", lambda: _family3(tmp, "instance"))):
        if not os.path.exists(os.path.join(tmp, name)):
            make()
    f2_ckpt = os.path.join(tmp, "family2.npz")
    if not os.path.exists(f2_ckpt):
        from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
        from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
        from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
            gram_attention_init,
        )

        save_pytree_npz(to_jax_tree(gram_attention_init(
            torch.Generator().manual_seed(0), 8, 4, POOL_S, device="cpu")), f2_ckpt)
    f1 = ["--family", "truncated_resnet50", "--config_path", f1_cfg, "--model_path",
          os.path.join(tmp, "family1.npz")]
    f2 = ["--family", "gram_attention", "--config_path", f2_cfg, "--model_path", f2_ckpt]
    int8 = ["--precision", "int8", "--quantized_path", qpath]
    if not os.path.exists(qpath):  # the serve phase writes it
        int8 += ["--calib_data", cal]
    cfg3 = MultiPatchGANConfig(norm="instance")
    f3t_cfg = os.path.join(tmp, "artifact_f3t.json")
    with open(f3t_cfg, "w") as f:
        json.dump(cfg3.to_dict(), f)
    style_paths = []
    for k in range(2):
        p = os.path.join(tmp, f"artifact_style_{k}.png")
        Image.fromarray(np.random.RandomState(380 + k).randint(
            0, 256, (256, 256, 3)).astype(np.uint8)).save(p)
        style_paths.append(p)
    loop = ["--num_iterations", str(ART_STYLE_ITERS), "--threshold", "0", "--max_delay_ms", "5"]
    texture = ["--config_path", f2_cfg, "--model_path", f2_ckpt, "--layers", "5",
               "--batch_size", "2"] + loop
    infer_cases = {
        "family1_float32": (f1, "float32", {}),
        "family1_bf16": (f1 + ["--precision", "bf16"], "bf16", {}),
        "family1_int8": (f1 + int8, "int8", {}),
        "family1_yuv420": (f1 + ["--transport", "yuv420"], "float32", {}),
        "family2_float32": (f2, "float32", {"pooled_gram_fwd": 4}),
        "family3_instance_float32": (["--family", "multi_patchgan", "--config_path", f3_cfg,
                                      "--model_path", f3_ckpt], "float32",
                                     {"instance_norm_fwd": F3_NORMS})}
    net_path = os.path.join(tmp, "style_net.npz")
    if not os.path.exists(net_path):  # written by the fast_style phase
        from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
        from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
            save_model_and_hyperparameters,
        )
        from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import (
            transformer_net_init,
        )

        save_model_and_hyperparameters(to_jax_tree(transformer_net_init(
            torch.Generator().manual_seed(0), width=32, n_res=5, device="cpu")),
            {"crop": 224, "style_names": ["seeded"]}, tmp, "style_net")
    styles = {
        "net": (["--net", net_path, "--batch_size", str(ART_NET_BATCH)], ART_NET_BATCH, 1),
        "texture_family2": (texture, 2, 1),
        "texture_family3_instance": (["--family", "multi_patchgan", "--config_path", f3t_cfg,
                                      "--model_path", os.path.join(tmp, "family3_instance.npz"),
                                      "--batch_size", "1"] + loop, 1, 1),
        "content_style": (["--config_path", f2_cfg, "--model_path", f2_ckpt, "--style_image",
                           f"a={style_paths[0]}", "--style_image", f"b={style_paths[1]}",
                           "--style_layers", "all", "--batch_size", "2"] + loop, 2, 2),
    }
    paths = {tag: os.path.join(tmp, f"artifact_{tag}.npz") for tag in [*infer_cases, *styles]}
    export_s = _export_all(
        {**{tag: ("serve", argv, paths[tag]) for tag, (argv, _, _) in infer_cases.items()},
         **{tag: ("serve_style", argv, paths[tag]) for tag, (argv, _, _) in styles.items()}},
        tmp)
    timings["artifact_exports_s"] = max(export_s.values())
    infer = {tag: _artifact_infer(kernels, tag, argv, precision, paths[tag], export_s[tag],
                                  per_forward)
             for tag, (argv, precision, per_forward) in infer_cases.items()}
    out["infer"] = infer

    # serve --artifact under load, against the direct forward of the live model
    clients = ProcessPoolExecutor(SERVE_CLIENT_PROCS, mp_context=multiprocessing.get_context(
        "spawn"))
    clients.submit(time.sleep, 0).result()
    frames = _serve_frames(345, SERVE_REQUESTS, SERVE_OVERSIZED)
    try:
        run = _serve_run(kernels, clients, "artifact_family2",
                         ["--artifact", infer["family2_float32"]["path"], "--batch_size",
                          str(SERVE_BATCH)], frames, "float32")
    finally:
        clients.shutdown()
    from heuristique_style_transfer_code_tpu_torch.cli import serve

    fwd, model, _, _ = serve._resolve_forward(serve.build_parser().parse_args(
        f2 + ["--device", DEVICE]))
    staged = torch.from_numpy(np.stack([prepare_frame(f, 224) for f in frames])).to(DEVICE)
    with torch.inference_mode():
        live = make_camera_infer_fn(fwd, batch=len(frames), host_downscale=True)(
            model, staged).cpu().numpy()
    live_gap = float(np.abs(run.pop("probs") - live).max())
    run["vs_live_model_max_gap"] = live_gap
    base = (serving or {}).get("family2_float32", {})
    nan = float("nan")
    print(f"[artifact] serve --artifact family 2: {run['images_per_s']:.1f} images/s, p50 "
          f"{run['p50_ms']:.2f} ms against live serving's {base.get('images_per_s', nan):.1f}"
          f" images/s, p50 {base.get('p50_ms', nan):.2f} ms (the serve phase, this run); "
          f"every answer vs the live model's b{len(frames)} forward: max |dprob| {live_gap:.3e}")
    _require(live_gap <= SERVE_TOL["float32"], "[artifact] serve --artifact answers as the model")
    _require(run["all_launches"]["pooled_gram_fwd"] == 4 * run["batches"],
             f"[artifact] serve --artifact: 4 pooled_gram_fwd a batch: {run['all_launches']}")
    out["serve"] = run

    # --recycle_after_requests with --artifact: the worker built from the file,
    # in a child process that runs beside the style artifacts' checks below
    # (their host times and its handover share the host's cores)
    rpaths = {k: os.path.join(tmp, f"artifact_recycle_{k}") for k in
             ("frames.npy", "probs.npy", "out.json", "spec.json")}
    rframes = np.stack(_serve_frames(361, ART_RECYCLE_REQUESTS, 0))
    np.save(rpaths["frames.npy"], rframes)
    spec = {"frames": rpaths["frames.npy"], "probs_out": rpaths["probs.npy"],
            "out": rpaths["out.json"], "kill_after": None, "style_argv": None,
            "serve_argv": ["--artifact", infer["family1_float32"]["path"], "--batch_size",
                           str(RECYCLE_BATCH), "--device", DEVICE, "--port", "0",
                           "--recycle_after_requests", str(ART_RECYCLE_AFTER),
                           "--request_timeout", str(RECYCLE_TIMEOUT_S)]}
    with open(rpaths["spec.json"], "w") as f:
        json.dump(spec, f)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--recycle-parent",
                             rpaths["spec.json"]], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        style_out = _artifact_style_checks(kernels, styles, paths, export_s, texture)
        child_out, child_err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        print(child_out[-4000:])
        print(child_err[-4000:], file=sys.stderr)
    _require(proc.returncode == 0, f"the artifact recycling parent exited {proc.returncode}")
    with open(rpaths["out.json"]) as f:
        res = json.load(f)["serve"]
    probs = np.load(rpaths["probs.npy"])
    f1_fwd, f1_model, _, _ = serve._resolve_forward(serve.build_parser().parse_args(
        f1 + ["--device", DEVICE]))
    with torch.inference_mode():
        want = make_camera_infer_fn(f1_fwd, batch=len(rframes), host_downscale=True)(
            f1_model, torch.from_numpy(rframes).to(DEVICE)).cpu().numpy()
    handovers = [h for h in res["handovers"] if h["recycle"] and not h["final"]]
    model_path = [h["seconds"] for h in ((recycle or {}).get("serve", {}).get("handovers", []))
                  if h["recycle"] and not h["final"]]
    gap = float(np.abs(probs - want).max())
    print(f"[artifact] --recycle_after_requests {ART_RECYCLE_AFTER} with --artifact (family 1 "
          f"f32, b{RECYCLE_BATCH}): {ART_RECYCLE_REQUESTS} POSTs, {res['stats']['recycles']} "
          f"recycles; handovers (s) "
          f"{[round(h['seconds'], 2) for h in handovers]} (the worker's build "
          f"{[round(h['build_s'], 2) for h in handovers]}) against the model path's "
          f"{[round(x, 2) for x in model_path]} (the recycle phase, this run); first build "
          f"{res['first_build_s']:.2f} s; vs the live model: max |dprob| {gap:.3e}")
    _require(all(st == 200 for st in res["statuses"]) and res["stats"]["recycles"] >= 1,
             f"[artifact] recycling from the artifact: {res['stats']}")
    _require(gap <= SERVE_TOL["float32"], "[artifact] the recycled artifact answers as the model")
    out["recycle"] = {k: res[k] for k in ("stats", "handovers", "first_start_s",
                                          "first_build_s", "images_per_s", "p50_ms")}
    out["recycle"]["model_path_handovers_s"] = model_path

    out["style"] = style_out
    launches = {k: 0 for k in kernels.launch_counts()}
    for res_ in infer.values():
        for row in res_["rows"]:
            for k, v in row["launches"].items():
                launches[k] += v
    for res_ in out["style"].values():
        for k, v in res_["launches"].items():
            launches[k] += v
    out["launches"] = launches
    timings["artifact_phase_s"] = time.perf_counter() - t_phase
    return out


def _artifact_style_checks(kernels, styles: dict, paths: dict, export_s: dict,
                           texture: list) -> dict:
    """The artifact phase's serve_style artifacts, each against live runs
    (``_artifact_style``): texture (family 2), family 3 (instance),
    content+style and the net; then one POST through the texture
    artifact's server."""
    import numpy as np

    out = {tag: _artifact_style(kernels, tag, argv, paths[tag], export_s[tag], batch, k,
                                iteration_host=tag == "texture_family3_instance",
                                net=tag == "net")
           for tag, (argv, batch, k) in styles.items()}
    f3s = out["texture_family3_instance"]["launches"]
    _require(f3s.get("instance_norm_fwd", 0) > 0 and f3s.get("instance_norm_bwd", 0) > 0,
             f"[artifact] the family-3 style artifact runs K3 and K3': {f3s}")
    srv, service, url = _serve(texture + ["--artifact", out["texture_family2"]["path"],
                                          "--port", "0", "--device", DEVICE])
    try:
        status, _, headers = _post_raw(url, np.random.RandomState(390).randint(
            0, 256, (224, 224, 3)).astype(np.uint8))
    finally:
        _stop(srv, service)
    print(f"[artifact] serve_style --artifact (texture) over HTTP: {status}, X-Iterations "
          f"{headers.get('X-Iterations')}")
    _require(status == 200 and headers.get("X-Iterations") == str(ART_STYLE_ITERS),
             "[artifact] serve_style --artifact answers a POST")
    return out


def phase_style_int8(kernels, model, seeded, timings: dict) -> dict:
    """The style loop's ``weights_int8`` (``tasks/style_transfer.py``) on the
    family-2 texture loop at serve_style's texture job shape (the
    classification phase's truncate-8 model, layers 5, b2, 224²,
    threshold 0): the int8 values and scales of the card's encoder equal
    the CPU's; the quantised Grams of a 64-px input on the card against the
    CPU (TOL_MODEL) and against f32 (JAX's bound: relative L2 in (0, 0.1));
    launches equal to the f32 loop's; image-iterations/s (host clock,
    synchronised) over SI8_ITERS iterations with and without the keyword,
    SI8_RUNS runs each, alternating, after a warm run."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_gram_fn_gram_attention,
        make_style_transfer_optimizer,
    )

    t_phase = time.perf_counter()
    fns = {q: make_gram_fn_gram_attention(model, 8, layers=5, weights_int8=q)
           for q in (False, True)}
    cpu_fn = make_gram_fn_gram_attention(seeded, 8, layers=5, weights_int8=True)
    same = all(torch.equal(q.cpu(), cpu_fn.quantised[n][0])
               and torch.equal(s.cpu(), cpu_fn.quantised[n][1])
               for n, (q, s) in fns[True].quantised.items())
    x = torch.from_numpy(np.random.RandomState(401).rand(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        card = fns[True](x.to(DEVICE))[0].cpu()
        f32 = fns[False](x.to(DEVICE))[0].cpu()
        cpu = cpu_fn(x)[0]
    vs_cpu = float((card - cpu).abs().max() / cpu.abs().max())
    vs_f32 = float(torch.linalg.norm(card - f32) / torch.linalg.norm(f32))
    print(f"[style_int8] {len(fns[True].quantised)} conv weights int8: card's int8 values and "
          f"scales equal the CPU's: {same}; quantised Grams (2 images 64 px) card vs CPU max rel "
          f"{vs_cpu:.3e} (tol {TOL_MODEL['float32'][0]}), int8 vs f32 rel L2 {vs_f32:.3e} "
          f"(JAX's bound (0, 0.1))")
    _require(same, "[style_int8] the card's int8 weights are the CPU's")
    _require(vs_cpu <= TOL_MODEL["float32"][0], f"[style_int8] card vs CPU: {vs_cpu}")
    _require(0.0 < vs_f32 < 0.1, f"[style_int8] int8 Grams within JAX's bound of f32: {vs_f32}")

    rng = np.random.RandomState(402)
    images = torch.from_numpy(rng.rand(SI8_BATCH, 224, 224, 3).astype(np.float32)).to(DEVICE)
    noise = torch.from_numpy(rng.randn(SI8_BATCH, 224, 224, 3).astype(np.float32)).to(DEVICE)
    runs = {}
    for q, fn in fns.items():
        with torch.no_grad():
            targets = fn(images)
        runs[q] = (make_style_transfer_optimizer(fn, 0.01, SI8_ITERS, 0.0), targets)
        runs[q][0](noise, targets)  # warm: cuDNN's choices
    rates, launches, losses = {False: [], True: []}, {}, {}
    for _ in range(SI8_RUNS):
        for q, (run, targets) in runs.items():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            _, iters, per = run(noise, targets)
            torch.cuda.synchronize()
            rates[q].append(SI8_BATCH * int(iters) / (time.perf_counter() - t0))
            launches[q] = kernels.launch_counts()
            losses[q] = torch.as_tensor(per).cpu().numpy()
    med = {q: float(np.median(r)) for q, r in rates.items()}
    out = {"quantised_equal_cpu": same, "vs_cpu": vs_cpu, "int8_vs_f32": vs_f32,
           "image_iterations_per_s": {"float32": med[False], "weights_int8": med[True]},
           "runs": {"float32": rates[False], "weights_int8": rates[True]},
           "launches": launches[True], "final_losses": {"float32": losses[False].tolist(),
                                                        "weights_int8": losses[True].tolist()}}
    print(f"[style_int8] texture loop b{SI8_BATCH} 224² layers 5, {SI8_ITERS} iterations: "
          f"{med[False]:.2f} image-iterations/s f32, {med[True]:.2f} with weights_int8 "
          f"(ratio {med[True] / med[False]:.3f}; runs {[round(r, 2) for r in rates[False]]}, "
          f"{[round(r, 2) for r in rates[True]]}); launches {launches[True]} (f32 "
          f"{launches[False]}); final losses f32 {losses[False]} int8 {losses[True]}")
    _require(launches[True] == launches[False] and launches[True]["gram_fwd"] >= SI8_ITERS
             and launches[True]["gram_bwd"] >= SI8_ITERS,
             f"[style_int8] the int8 loop's launches are the f32 loop's: {launches}")
    _require(bool(np.isfinite(losses[True]).all()), "[style_int8] finite losses")
    timings["style_int8_phase_s"] = time.perf_counter() - t_phase
    return out


def _toolchain() -> dict:
    """Whether this machine has ``g++`` and libjpeg's ``jpeglib.h`` (what
    the native decoder's build needs)."""
    import shutil

    gxx = shutil.which("g++") is not None
    header = gxx and subprocess.run(
        ["g++", "-fsyntax-only", "-x", "c++", "-"], input="#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True, timeout=60).returncode == 0
    return {"g++": gxx, "jpeglib.h": bool(header)}


def phase_native_decode(tmp: str, timings: dict) -> dict:
    """The host loader's native JPEG decoder (``native/``). First, on a line
    of its own, whether the machine has ``g++`` and ``jpeglib.h``. Where it
    has both: the decoder built from the checkout under
    ``HST_NATIVE_DECODE=1`` (a failed build fails the smoke), its staged
    canvases bit-equal to PIL's on ND_IMAGES JPEGs; ``HostLoader``'s
    images/s at b32 with the train CLIs' decode workers, native against
    PIL (``HST_NATIVE_DECODE=0``), ND_EPOCHS epochs each over the same files
    (the file cache warm), medians. Where not: PIL alone, and why."""
    import numpy as np
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch import native
    from heuristique_style_transfer_code_tpu_torch.data import loader

    t_phase = time.perf_counter()
    tools = _toolchain()
    print(json.dumps(tools))
    root = os.path.join(tmp, "nd_data")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(410)
    h, w = ND_SIZE
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    samples = []
    for i in range(ND_IMAGES):
        arr = np.clip(smooth + rng.randint(-60, 60, (h, w, 3)), 0, 255).astype(np.uint8)
        path = os.path.join(root, f"img_{i:04d}.jpg")
        Image.fromarray(arr).save(path, quality=90, subsampling=(0, 1, 2)[i % 3])
        samples.append((path, i % 4))
    modes = ("0", "1") if tools["g++"] and tools["jpeglib.h"] else ("0",)
    if len(modes) == 1:
        print("[native_decode] g++ or jpeglib.h is missing on this machine: the native decoder "
              "cannot be built here; PIL alone is measured")
    old = {k: os.environ.get(k) for k in ("HST_NATIVE_DECODE", "HST_NATIVE_DECODE_FAST")}
    os.environ.pop("HST_NATIVE_DECODE_FAST", None)
    out = {"toolchain": tools, "images": ND_IMAGES, "size": list(ND_SIZE), "batch": ND_BATCH,
           "workers": loader.DECODE_WORKERS, "images_per_s": {}, "epochs": {}}
    first = {}
    try:
        for mode in modes:
            os.environ["HST_NATIVE_DECODE"] = mode
            if mode == "1":
                t0 = time.perf_counter()
                dec = native.get_decoder()
                out["build_s"] = time.perf_counter() - t0
                out["library"] = os.path.relpath(dec.so_path, REPO)
            rates = []
            for _ in range(ND_EPOCHS):
                hl = loader.HostLoader(samples, ND_BATCH)
                t0 = time.perf_counter()
                for b, batch in enumerate(hl):
                    if b == 0:
                        first[mode] = batch["image"]
                rates.append(len(samples) / (time.perf_counter() - t0))
            name = "native" if mode == "1" else "pil"
            out["epochs"][name] = rates
            out["images_per_s"][name] = float(np.median(rates))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rates = out["images_per_s"]
    if "native" in rates:
        equal = bool(np.array_equal(first["0"], first["1"]))
        out["native_equals_pil"] = equal
        print(f"[native_decode] built {out['library']} in {out['build_s']:.2f} s; HostLoader "
              f"b{ND_BATCH}, {loader.DECODE_WORKERS} decode workers, {ND_IMAGES} JPEGs "
              f"{w}x{h} (4:4:4, 4:2:2, 4:2:0; warm file cache): native {rates['native']:.1f} "
              f"images/s, PIL {rates['pil']:.1f} (x{rates['native'] / rates['pil']:.2f}; epochs "
              f"{[round(r, 1) for r in out['epochs']['native']]}, "
              f"{[round(r, 1) for r in out['epochs']['pil']]}); first batch bit-equal: {equal}")
        _require(equal, "[native_decode] the native batch is PIL's bit for bit")
    else:
        print(f"[native_decode] HostLoader b{ND_BATCH}, {loader.DECODE_WORKERS} decode workers, "
              f"{ND_IMAGES} JPEGs {w}x{h}: PIL {rates['pil']:.1f} images/s")
    timings["native_decode_phase_s"] = time.perf_counter() - t_phase
    return out


def _vmap_ops_on_card(kernels) -> dict:
    """The seven ``hst`` ops under ``torch.func.vmap`` on CUDA tensors, K =
    PF_K folds folded into one launch: each vmapped op (and each shim under
    ``vmap(grad(...))``: its forward and its backward op) against the same
    kernels called fold by fold, max |difference| relative to the result's
    scale within PF_TOL_OP (the kernels plan their splits by the batch, so
    f32 sums may run in another order), one launch each; each op's folded
    launch timed (``_time_ms``) beside its K launches fold by fold."""
    import torch
    from torch.func import grad, vmap

    from heuristique_style_transfer_code_tpu_torch.ops.kernels import gram as kg
    from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

    gen = torch.Generator(device=DEVICE).manual_seed(420)
    k, n, hw, c, s = PF_K, 4, 56 * 56, 256, POOL_S

    def r(*shape, pos=False):
        t = torch.randn(shape, device=DEVICE, generator=gen)
        return t.relu() if pos else t

    f, dg, ds = r(k, n, hw, c, pos=True), r(k, n, c, c), r(k, n, s, s)
    x, sc, b = r(k, n, hw, 64), r(k, n, 64).abs() + 0.5, r(k, n, 64)
    with torch.no_grad():
        y = torch.stack([kg.pooled_gram_fwd(f[i], s, return_y=True)[1] for i in range(k)])
        yin = torch.stack([kin.instance_norm_fwd(x[i], sc[i], b[i], relu=True) for i in range(k)])
    cases = {
        "gram_fwd": (lambda: vmap(torch.ops.hst.gram_fwd)(f),
                     lambda i: kg.gram_fwd(f[i])),
        "gram_bwd": (lambda: vmap(torch.ops.hst.gram_bwd)(f, dg),
                     lambda i: kg.gram_bwd(f[i], dg[i])),
        "pooled_gram_fwd": (lambda: vmap(torch.ops.hst.pooled_gram_fwd, (0, None))(f, s),
                            lambda i: kg.pooled_gram_fwd(f[i], s)),
        "pooled_gram_fwd_y": (lambda: vmap(torch.ops.hst.pooled_gram_fwd_y, (0, None))(f, s)[1],
                              lambda i: y[i]),
        "pooled_gram_bwd": (lambda: vmap(torch.ops.hst.pooled_gram_bwd, (0, 0, None, None))(
            y, ds, c, torch.float32), lambda i: kg.pooled_gram_bwd(y[i], ds[i], c, torch.float32)),
        "instance_norm_fwd": (lambda: vmap(torch.ops.hst.instance_norm_fwd,
                                           (0, 0, 0, None, None))(x, sc, b, kin.EPS, True),
                              lambda i: yin[i]),
        "instance_norm_bwd": (lambda: vmap(torch.ops.hst.instance_norm_bwd,
                                           (0, 0, 0, 0, None, None, 0))(
            x, x, sc, b, kin.EPS, True, yin)[0],
            lambda i: kin.instance_norm_bwd(x[i], x[i], sc[i], b[i], kin.EPS, True, yin[i])[0]),
    }

    def gram_loss(f):
        return kg.GramFunction.apply(f).square().sum() + kg.PooledGramFunction.apply(f, s).sum()

    def norm_loss(x, sc, b):
        return kin.InstanceNormFunction.apply(x, sc, b, kin.EPS, True).square().sum()

    def loop_grad(fn, *args):
        outs = []
        for i in range(k):
            leaves = [a[i].clone().requires_grad_(True) for a in args]
            outs.append(torch.autograd.grad(fn(*leaves), leaves)[0])
        return torch.stack(outs)

    # the kernels fold by fold, for the times beside the folded launch
    loops = {
        "gram_fwd": lambda i: kg.gram_fwd(f[i]),
        "gram_bwd": lambda i: kg.gram_bwd(f[i], dg[i]),
        "pooled_gram_fwd": lambda i: kg.pooled_gram_fwd(f[i], s),
        "pooled_gram_fwd_y": lambda i: kg.pooled_gram_fwd(f[i], s, return_y=True),
        "pooled_gram_bwd": lambda i: kg.pooled_gram_bwd(y[i], ds[i], c, torch.float32),
        "instance_norm_fwd": lambda i: kin.instance_norm_fwd(x[i], sc[i], b[i], relu=True),
        "instance_norm_bwd": lambda i: kin.instance_norm_bwd(x[i], x[i], sc[i], b[i], kin.EPS,
                                                             True, yin[i]),
    }
    cases["vmap(grad(gram + pooled gram))"] = (lambda: vmap(grad(gram_loss))(f),
                                               lambda i: loop_grad(gram_loss, f)[i])
    cases["vmap(grad(instance norm))"] = (lambda: vmap(grad(norm_loss))(x, sc, b),
                                          lambda i: loop_grad(norm_loss, x, sc, b)[i])
    out = {}
    for name, (batched, per_fold) in cases.items():
        kernels.reset_launch_counts()
        got = batched()
        torch.cuda.synchronize()
        launched = {kk: v for kk, v in kernels.launch_counts().items() if v}
        want = torch.stack([per_fold(i) for i in range(k)])
        err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        out[name] = {"rel_err": err, "launches": launched}
        if name in loops:
            out[name]["ms"] = _time_ms(batched)
            out[name]["folds_one_by_one_ms"] = _time_ms(
                lambda fn=loops[name]: [fn(i) for i in range(k)])
        _require(err <= PF_TOL_OP, f"[parallel_folds] {name} under vmap: rel err {err}")
        _require(launched and all(v == 1 for v in launched.values()),
                 f"[parallel_folds] {name} under vmap: one launch a kernel for {k} folds: "
                 f"{launched}")
    print(f"[parallel_folds] the hst ops under vmap on the card, {k} folds (rel err, launches; "
          f"device ms of the folded launch and of the {k} launches fold by fold): "
          + "; ".join(f"{nm} {r['rel_err']:.2e} {r['launches']}"
                      + (f" {r['ms']:.4f} vs {r['folds_one_by_one_ms']:.4f} ms" if "ms" in r
                         else "") for nm, r in out.items()))
    return out


def _train_launches(kernels, run) -> tuple:
    """``run()``'s hand-written kernel launches, all of them and those of
    its validation passes (``train.kfold.evaluate``) apart."""
    from heuristique_style_transfer_code_tpu_torch.train import kfold

    real, evals = kfold.evaluate, {}

    def counted(*args, **kw):
        before = kernels.launch_counts()
        try:
            return real(*args, **kw)
        finally:
            for kk, v in kernels.launch_counts().items():
                evals[kk] = evals.get(kk, 0) + v - before[kk]

    kfold.evaluate = counted
    try:
        kernels.reset_launch_counts()
        run()
        return kernels.launch_counts(), evals
    finally:
        kfold.evaluate = real


def _batch_losses(text: str) -> dict:
    """{"fold/batch": loss} of a train CLI's per-batch lines."""
    import re

    return {f"{m[0]}/{m[1]}": float(m[2]) for m in re.findall(
        r"Fold (\d+), Epoch \[\d+/\d+\], Batch \[(\d+)/\d+\], Loss: ([-\d.naif]+)", text)}


def phase_parallel_folds(kernels, tmp: str, timings: dict) -> dict:
    """``--parallel_folds`` on the card (``parallel/foldparallel.py``). (a)
    ``_vmap_ops_on_card``. (b) ``train_gram_attention`` (truncate 7, S 7,
    b32: K2 and K2′) and ``train_multi_patchgan`` (the config defaults,
    norm "instance", b32: K3 and K3′) with ``--k_folds 2 --epochs 1`` on 4
    classes x PF_PER_CLASS PNGs (2 steps a fold), with and without
    ``--parallel_folds``: each fold's move from its init (its checkpoint
    against the same init) by relative L2 within PF_TOL_MOVE and each
    printed batch loss within PF_TOL_LOSS of the sequential run's (see
    PF_TOL_MOVE's note), and the training's launches of every kernel (the
    validation passes' apart) the sequential run's divided by K. (c) The b32 steps in memory:
    images/s of PF_TIMED rounds (both folds stepped) with the fold-parallel
    step against the two sequential steps, after a warm round, and each
    one's peak memory, device busy and idle share and top kernels over 2
    profiled rounds."""
    import contextlib
    import io

    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli.train_gram_attention import main as f2_cli
    from heuristique_style_transfer_code_tpu_torch.cli.train_multi_patchgan import main as f3_cli
    from heuristique_style_transfer_code_tpu_torch.config.schema import (
        GramAttentionConfig,
        MultiPatchGANConfig,
    )
    from heuristique_style_transfer_code_tpu_torch.parallel.foldparallel import (
        stack_fold_states,
    )
    from heuristique_style_transfer_code_tpu_torch.tools.profile_main_path import _profile
    from heuristique_style_transfer_code_tpu_torch.train.factories import (
        setup_gram_attention,
        setup_multi_patchgan,
    )

    t_phase = time.perf_counter()
    out = {"ops": _vmap_ops_on_card(kernels)}
    data = _image_folder(os.path.join(tmp, "pf_data"), PF_PER_CLASS, seed=421, split="train")
    families = {
        "family2": (f2_cli, GramAttentionConfig(batch_size=PF_BATCH, lr=F2T_LR,
                                                truncate_layer=F2T_TRUNCATE,
                                                gram_matrix_size=F2T_S, seed=0),
                    setup_gram_attention, ("pooled_gram_fwd", "pooled_gram_bwd")),
        "family3": (f3_cli, MultiPatchGANConfig(batch_size=PF_BATCH, lr=F3T_LR, norm="instance",
                                                seed=0),
                    setup_multi_patchgan, ("instance_norm_fwd", "instance_norm_bwd")),
    }
    launches = {kk: 0 for kk in kernels.launch_counts()}
    for fam, (cli, cfg, setup_fn, used) in families.items():
        cfg_path = os.path.join(tmp, f"pf_{fam}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg.to_dict(), f)
        runs = {}
        for flag in (False, True):
            save = os.path.join(tmp, f"pf_{fam}_{'parallel' if flag else 'sequential'}")
            argv = ["--data", data, "--config_path", cfg_path, "--k_folds", str(PF_K),
                    "--epochs", "1", "--save_dir", save, "--device", DEVICE]
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                total, evals = _train_launches(
                    kernels, lambda: cli(argv + (["--parallel_folds"] if flag else [])))
            torch.cuda.synchronize()
            train = {kk: total[kk] - evals.get(kk, 0) for kk in total}
            runs[flag] = {"seconds": time.perf_counter() - t0, "train_launches": train,
                          "eval_launches": evals, "losses": _batch_losses(printed.getvalue()),
                          "dir": save}
            if flag:
                for kk, v in total.items():
                    launches[kk] += v
        seq, par = runs[False], runs[True]
        leaf, moves = {}, []
        for fold in range(PF_K):
            start = setup_fn(cfg, 4, [(None, None)], device="cpu").init(
                torch.Generator().manual_seed(cfg.seed + fold))[0]
            w0 = _flatten(to_jax_tree(start))
            a, b = (_flatten(load_pytree_npz(os.path.join(r["dir"], f"best_model_fold_{fold}.npz")))
                    for r in (seq, par))
            d = {key: np.asarray(b[key], np.float64) - a[key] for key in a}
            m = {key: np.asarray(a[key], np.float64) - w0[key] for key in a}
            move = sum(float((v * v).sum()) for v in m.values()) ** 0.5
            moves.append(sum(float((v * v).sum()) for v in d.values()) ** 0.5 / move)
            for key in a:  # leaves that moved (a bias before a norm has no gradient)
                if np.linalg.norm(m[key]) > 1e-6 * move:
                    leaf[f"{fold}/{key}"] = float(np.linalg.norm(d[key]) / np.linalg.norm(m[key]))
        worst = max(leaf, key=leaf.get)
        loss_gap = max(abs(seq["losses"][key] - par["losses"][key]) for key in seq["losses"])
        ratio_ok = all(par["train_launches"][kk] * PF_K == seq["train_launches"][kk]
                       for kk in par["train_launches"])
        out[fam] = {"cli": {("parallel" if f else "sequential"): {
            kk: v for kk, v in r.items() if kk != "dir"} for f, r in runs.items()},
            "move_gap": moves, "worst_leaf_move_gap": [worst, leaf[worst]],
            "max_loss_gap": loss_gap}
        print(f"[parallel_folds] {fam} CLI, {PF_K} folds x 1 epoch at b{PF_BATCH}: sequential "
              f"{seq['seconds']:.1f} s, --parallel_folds {par['seconds']:.1f} s; training "
              f"launches {seq['train_launches']} -> {par['train_launches']} (validation "
              f"{par['eval_launches']}); each fold's move from its init, fold-parallel "
              f"against sequential, rel L2 {[f'{m:.2e}' for m in moves]} (tol {PF_TOL_MOVE}; "
              f"worst leaf {leaf[worst]:.2e}, {worst}), batch losses max gap {loss_gap:.1e} "
              f"(tol {PF_TOL_LOSS}): {sorted(par['losses'].items())}")
        _require(seq["losses"].keys() == par["losses"].keys() and len(par["losses"]) >= 2 * PF_K,
                 f"[parallel_folds] {fam}: every fold's batch lines in both runs")
        _require(ratio_ok and all(par["train_launches"][kk] > 0 for kk in used),
                 f"[parallel_folds] {fam}: training launches the sequential count / {PF_K}: "
                 f"{seq['train_launches']} -> {par['train_launches']}")
        _require(max(moves) <= PF_TOL_MOVE and loss_gap <= PF_TOL_LOSS,
                 f"[parallel_folds] {fam}: fold-parallel weights and losses are sequential's")

        # (c) the steps in memory
        setup = setup_fn(cfg, 4, [(None, None)], device=DEVICE)
        rng = np.random.RandomState(430)
        batches = [{"image": rng.randint(0, 256, (PF_BATCH, 256, 256, 3)).astype(np.uint8),
                    "label": rng.randint(0, 4, (PF_BATCH,)).astype(np.int32), "combo": None,
                    "draws": None} for _ in range(PF_K)]
        states = [setup.init(torch.Generator().manual_seed(431 + i)) for i in range(PF_K)]
        step = setup.foldwise_step()
        rates, peaks, profiles = {}, {}, {}
        for mode in ("sequential", "parallel"):
            if mode == "parallel":
                stacked = stack_fold_states(states)

                def round_():
                    step(stacked, batches, [True] * PF_K)
            else:
                def round_():
                    for (m, o), bt in zip(states, batches):
                        setup.train_step(m, o, bt["image"], bt["label"])
            round_()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(PF_TIMED):
                round_()
            torch.cuda.synchronize()
            rates[mode] = PF_K * PF_BATCH * PF_TIMED / (time.perf_counter() - t0)
            peaks[mode] = torch.cuda.max_memory_allocated() / 2**30
            prof = _profile(round_, 2)
            profiles[mode] = {"busy_ms": prof["device_busy_ms"] / 2,
                              "idle_share": prof["idle_share"],
                              "top_kernels": [(k["name"][:60], round(k["ms"] / 2, 3))
                                              for k in prof["top_kernels"][:6]]}
        del states, step, setup
        out[fam]["images_per_s"] = rates
        out[fam]["peak_gib"] = peaks
        out[fam]["profile"] = profiles
        print(f"[parallel_folds] {fam} b{PF_BATCH} f32 steps of {PF_K} folds ({PF_TIMED} rounds, "
              f"staged uint8 to the SGD update, host clock): --parallel_folds "
              f"{rates['parallel']:.1f} images/s, sequential {rates['sequential']:.1f} (x"
              f"{rates['parallel'] / rates['sequential']:.3f}); peak memory "
              f"{peaks['parallel']:.2f} against {peaks['sequential']:.2f} GiB; a round's device "
              f"busy {profiles['parallel']['busy_ms']:.2f} against "
              f"{profiles['sequential']['busy_ms']:.2f} ms, idle share "
              f"{profiles['parallel']['idle_share']:.3f} against "
              f"{profiles['sequential']['idle_share']:.3f}; top kernels (ms a round) "
              f"{profiles['parallel']['top_kernels']} against "
              f"{profiles['sequential']['top_kernels']}")
    out["launches"] = launches
    timings["parallel_folds_phase_s"] = time.perf_counter() - t_phase
    return out


def _dp_batches(reverse: bool = False):
    """The data_parallel runs' DP_STEPS + 1 global batches (each half dark,
    half bright; one pad entry in the first) and their labels; with
    ``reverse`` each batch's rows in reverse order."""
    import numpy as np

    rng = np.random.RandomState(110)
    half = (DP_BATCH // 2, 256, 256, 3)
    u8 = [np.concatenate([rng.randint(0, 90, half), rng.randint(160, 256, half)]).astype(np.uint8)
          for _ in range(DP_STEPS + 1)]
    labels = [rng.randint(0, 4, (DP_BATCH,)).astype(np.int32) for _ in range(DP_STEPS + 1)]
    labels[0][-1] = -1
    if reverse:
        u8, labels = [x[::-1].copy() for x in u8], [y[::-1].copy() for y in labels]
    return u8, labels


def _model_axis_runs(world) -> dict:
    """The data_parallel phase's model-axis cases (MA_CASES) on the ranks of
    ``world`` (every rank builds every mesh, in one order). Each case: the
    global losses, the gathered tree after the first step,
    the launches, the steps' seconds, the peak of device memory, the bytes
    a rank stores of the parameters and the optimiser state beside the
    whole model's, and digests of the leaves the mesh replicates and of
    the gathered tree."""
    import hashlib

    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.parallel import sharding
    from heuristique_style_transfer_code_tpu_torch.parallel.tensor_parallel import gather_heads
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention
    from heuristique_style_transfer_code_tpu_torch.train.optim import full_params, sgd_momentum

    cards = [world.device] * world.world_size
    meshes = {"2d": sharding.make_mesh_2d(world.world_size, devices=cards), "data": world,
              "3d": sharding.make_mesh_3d(world.world_size, devices=cards)}
    u8, labels = _dp_batches()
    cfg = GramAttentionConfig(batch_size=DP_BATCH, lr=DP_LR, truncate_layer=F2T_TRUNCATE,
                              gram_matrix_size=F2T_S, seed=0)
    setup = setup_gram_attention(cfg, 4, [(None, None)], device=DEVICE)

    def nbytes(tensors) -> int:
        return int(sum(t.numel() * t.element_size() for t in tensors))

    def gathered(model, state):
        whole = full_params(model, state)
        tensors = gather_heads(whole)
        return whole, tensors, to_jax_tree(whole, tensors)

    runs = {}
    with _deterministic_cudnn():
        for name, mesh_name, factory in MA_CASES:
            t_case = time.perf_counter()
            mesh = meshes[mesh_name]
            model, _ = setup.init(torch.Generator().manual_seed(111))
            whole_bytes = {"params": nbytes(model.parameters()),
                           "state": nbytes(model.parameters())}  # the momentum: one a parameter
            opt = sgd_momentum(DP_LR, mesh=mesh)
            fwd, aug = setup._forward_train, setup._augment
            if factory == "sharded":
                step, _ = sharding.make_sharded_train_step(fwd, opt, aug, mesh, model)
                state = opt[0](model)
            elif factory == "zero1":
                state = opt[0](model)
                step, _ = sharding.make_zero1_train_step(fwd, opt, aug, mesh, model, state)
            else:
                state = opt[0](model)
                step, _, _ = sharding.make_fsdp_train_step(fwd, opt, aug, mesh, model, state)
            stored = {"params": nbytes(model.parameters()),
                      "state": nbytes(state["trace"].values())}
            losses, seconds = [], []
            kernels.reset_launch_counts()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            for i in range(MA_STEPS):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                model, state, loss = step(model, state, mesh.local(u8[i]), mesh.local(labels[i]))
                losses.append(float(loss))  # the global loss: a sync
                seconds.append(time.perf_counter() - t0)
                if i == 0:
                    first = gathered(model, state)[2]
            launches = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None
            tensors = gathered(model, state)[1]
            local = model.state_dict()
            replicated = hashlib.sha256()
            for k in sorted(local):
                if tuple(local[k].shape) == tuple(tensors[k].shape):
                    replicated.update(local[k].detach().cpu().numpy().tobytes())
            whole = hashlib.sha256()
            for k in sorted(tensors):
                whole.update(tensors[k].detach().cpu().numpy().tobytes())
            runs[name] = {"losses": losses, "seconds": seconds, "launches": launches,
                          "peak_bytes": peak, "stored_bytes": stored, "whole_bytes": whole_bytes,
                          "replicated_digest": replicated.hexdigest(),
                          "whole_digest": whole.hexdigest(), "tree1": first,
                          "case_s": time.perf_counter() - t_case}
            del model, state, step
    return runs


def _f2_defaults(mesh=None):
    """Family 2 at its config defaults (truncate 7, S 7, b{DP_BATCH}) as the
    data_parallel runs build it, on ``mesh`` (None: one device)."""
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention

    cfg = GramAttentionConfig(batch_size=DP_BATCH, lr=DP_LR, truncate_layer=F2T_TRUNCATE,
                              gram_matrix_size=F2T_S, seed=0)
    return setup_gram_attention(cfg, 4, [(None, None)], device=DEVICE, mesh=mesh)


def _sharded_ckpt_runs(world, out_dir: str) -> dict:
    """The data_parallel phase's sharded-checkpoint case on this rank (see
    SC_STEPS): FSDP on ``world``, the asynchronous save after step 2 while
    step 3 runs, the synchronous save after step 3, the reload against
    the copy kept before step 3; losses, launches, seconds, bytes."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint import sharded_io
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.parallel import sharding
    from heuristique_style_transfer_code_tpu_torch.train.optim import sgd_momentum

    t_case = time.perf_counter()
    setup = _f2_defaults()
    u8, labels = _dp_batches()

    def fsdp(seed):
        model, _ = setup.init(torch.Generator().manual_seed(seed))
        opt = sgd_momentum(DP_LR, mesh=world)
        state = opt[0](model)
        step, _, _ = sharding.make_fsdp_train_step(setup._forward_train, opt, setup._augment,
                                                   world, model, state)
        return model, state, step

    def local(model, state):
        out = {f"variables/{k}": v for k, v in model.state_dict().items()}
        out.update({f"trace/{k}": v for k, v in state["trace"].items()})
        return {k: v.detach().cpu().clone() for k, v in out.items()}

    mid, fin = os.path.join(out_dir, "sharded_mid"), os.path.join(out_dir, "sharded_fin")
    model, state, step = fsdp(111)
    losses, seconds = [], {}
    with _deterministic_cudnn():
        kernels.reset_launch_counts()
        for i in range(SC_STEPS - 1):
            model, state, loss = step(model, state, world.local(u8[i]), world.local(labels[i]))
            losses.append(float(loss))
        kept = local(model, state)
        writer = sharded_io.make_async_sharded_writer()
        t0 = time.perf_counter()
        writer.submit(sharded_io.state_tree(model, state, world), mid)
        seconds["submit"] = time.perf_counter() - t0
        model, state, loss = step(model, state, world.local(u8[SC_STEPS - 1]),
                                  world.local(labels[SC_STEPS - 1]))
        losses.append(float(loss))  # the global loss: a sync
        seconds["submit_to_step_end"] = time.perf_counter() - t0
        writer.close()
        seconds["submit_to_commit"] = time.perf_counter() - t0
        launches = kernels.launch_counts()
        t0 = time.perf_counter()
        sharded_io.save_sharded_pytree(sharded_io.state_tree(model, state, world), fin)
        seconds["sync_save"] = time.perf_counter() - t0
    fresh, fresh_state, _ = fsdp(5)
    t0 = time.perf_counter()
    sharded_io.load_state(mid, fresh, fresh_state)
    seconds["load"] = time.perf_counter() - t0
    got = local(fresh, fresh_state)
    equal = got.keys() == kept.keys() and all(torch.equal(got[k], kept[k]) for k in kept)
    stored = sum(t.numel() * t.element_size() for t in kept.values())
    return {"losses": losses, "launches": launches, "seconds": seconds,
            "reload_equal": bool(equal), "count": fresh_state["count"],
            "bytes_written": os.path.getsize(os.path.join(mid, f"shards_p{world.rank:05d}.npz")),
            "bytes_held": stored, "case_s": time.perf_counter() - t_case}


def _stride_batch(data_root: str, index: int, count: int) -> dict:
    """The first batch of process ``index`` of ``count`` of the loader's
    stride over the evaluation cases' test split (see SC_SEED)."""
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader

    loader = HostLoader(ImageFolderIndex(os.path.join(data_root, "test")).samples,
                        DP_BATCH // count, shuffle=True, seed=SC_SEED, process_index=index,
                        process_count=count)
    batches = iter(loader)
    try:
        return next(batches)
    finally:
        batches.close()


def _stride_run(world, data_root: str) -> dict:
    """The data_parallel phase's loader-stride case on this rank: its
    stride's first batch through ``global_batch_dict``, one plain
    data-parallel family-2 step; the loss, the tree after it, the batch's
    indices and the launches."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import global_batch_dict
    from heuristique_style_transfer_code_tpu_torch.parallel.sharding import (
        batch_sharding,
        image_sharding,
    )

    t_case = time.perf_counter()
    batch = _stride_batch(data_root, world.data_index, world.data_axis.world_size)
    g = global_batch_dict(batch, image_sharding(world), batch_sharding(world))
    setup = _f2_defaults(world)
    model, opt = setup.init(torch.Generator().manual_seed(111))
    with _deterministic_cudnn():
        kernels.reset_launch_counts()
        model, opt, loss = setup.train_step(model, opt, g["image"], g["label"])
        loss = float(loss)
        launches = kernels.launch_counts()
    return {"loss": loss, "tree": to_jax_tree(model), "indices": batch["indices"].tolist(),
            "n_valid": batch["n_valid"], "launches": launches,
            "case_s": time.perf_counter() - t_case}


def _dp_runs(mesh, profile: bool = False, reverse: bool = False,
             names=("f2", "f2_zero1", "f3_instance")) -> dict:
    """The data_parallel phase's runs on ``mesh`` (None: one rank): family
    2 (truncate 7, S 7) plain and under ZeRO-1, family 3 (defaults,
    "instance"), DP_STEPS f32 steps each from the same seeded weights on
    this rank's rows of the same global batches (one pad entry in the
    first), under cuDNN's deterministic algorithms. Each run: the global
    losses, the tree after the first step and the final one (JAX layout),
    the launches, the steps' seconds;
    with ``profile`` one more step of the plain family-2 run under the
    profiler (every rank runs it: it has collectives) and its collectives'
    host ms. ``reverse`` (one rank) takes each batch's rows in reverse
    order: the same sums in another order, the one-rank run's own f32
    reduction-order spread."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.config.schema import (
        GramAttentionConfig,
        MultiPatchGANConfig,
    )
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.train.factories import (
        setup_gram_attention,
        setup_multi_patchgan,
    )

    u8, labels = _dp_batches(reverse)
    local = (lambda x: x) if mesh is None else mesh.local  # noqa: E731
    combos = [(None, None)]
    runs = {}
    with _deterministic_cudnn():
        for name in names:
            if name.startswith("f2"):
                cfg = GramAttentionConfig(batch_size=DP_BATCH, lr=DP_LR,
                                          truncate_layer=F2T_TRUNCATE, gram_matrix_size=F2T_S,
                                          seed=0)
                setup = setup_gram_attention(cfg, 4, combos, device=DEVICE, mesh=mesh,
                                             zero1=name.endswith("zero1"))
            else:
                cfg = MultiPatchGANConfig(batch_size=DP_BATCH, lr=DP_LR, norm="instance", seed=0)
                setup = setup_multi_patchgan(cfg, 4, combos, device=DEVICE, mesh=mesh)
            model, opt = setup.init(torch.Generator().manual_seed(111))
            init = to_jax_tree(model)
            losses, seconds = [], []
            kernels.reset_launch_counts()
            for i in range(DP_STEPS):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                model, opt, loss = setup.train_step(model, opt, local(u8[i]), local(labels[i]))
                losses.append(float(loss))  # the global loss: a sync
                seconds.append(time.perf_counter() - t0)
                if i == 0:
                    first = to_jax_tree(model)
            launches = kernels.launch_counts()
            run = {"losses": losses, "seconds": seconds, "launches": launches,
                   "init": init, "tree1": first, "tree": to_jax_tree(model)}
            if "zero1" in opt:
                split, repl = opt["zero1"].state_bytes(opt["trace"])
                whole = sum(t.numel() * t.element_size() for t in opt["trace"].values())
                run["state_bytes"] = {"rank_split": split, "rank_replicated": repl,
                                      "rank_total": split + repl,
                                      "replicated_state": whole if mesh is None else None}
            elif name == "f2":
                run["state_bytes"] = {"rank_total": sum(
                    t.numel() * t.element_size() for t in opt["trace"].values())}
            if profile and name == "f2":
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as torch_profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                with torch_profile(activities=activities) as prof:
                    model, opt, loss = setup.train_step(model, opt, local(u8[DP_STEPS]),
                                                        local(labels[DP_STEPS]))
                    float(loss)
                coll = {}
                for e in prof.key_averages():  # a CPU and a device entry a key
                    if e.key.startswith("hst_dp::"):
                        coll[e.key] = coll.get(e.key, 0.0) + e.cpu_time_total / 1e3
                run["collectives_ms"] = coll
                busy = sum(e.self_device_time_total for e in prof.key_averages()
                           if e.device_type.name == "CUDA") / 1e3
                run["profiled_step_device_busy_ms"] = busy
            runs[name] = run
            del model, opt, setup
    return runs


def _fold_mesh_runs(mesh, reverse: bool = False) -> dict:
    """The data_parallel phase's fold-mesh cases (PFM_CASES) on ``mesh``,
    the world of its ranks (None: one device, every fold and row;
    ``reverse``: each batch's rows reversed, the one device's own f32
    spread). Each case: this rank's folds and their losses a step, their
    trees after the first step, every fold's tree after the last (shared
    from its group's first rank on ranks), the launches, the steps'
    seconds, a digest of the shared states, and on one device the inits."""
    import hashlib

    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.core.mesh import FoldMesh
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.parallel.foldparallel import (
        broadcast_fold_states,
        stack_fold_states,
        unstack_fold_state,
    )
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention

    cfg = GramAttentionConfig(batch_size=DP_BATCH, lr=DP_LR, truncate_layer=F2T_TRUNCATE,
                              gram_matrix_size=F2T_S, seed=0)
    half = (DP_BATCH // 2, 256, 256, 3)
    order = np.arange(DP_BATCH)[::-1] if reverse else np.arange(DP_BATCH)
    out = {}
    with _deterministic_cudnn():
        for k, fold, data in PFM_CASES:
            t_case = time.perf_counter()
            rng = np.random.RandomState(120 + k)
            u8 = [[np.concatenate([rng.randint(0, 90, half), rng.randint(160, 256, half)])
                   .astype(np.uint8) for _ in range(k)] for _ in range(PFM_STEPS)]
            labels = [[rng.randint(0, 4, (DP_BATCH,)).astype(np.int32) for _ in range(k)]
                      for _ in range(PFM_STEPS)]
            fm = FoldMesh(mesh, k, fold, data, mesh.world_size) if mesh is not None else None
            local = list(fm.folds()) if fm is not None else list(range(k))
            rows = order[fm.data_axis.rows(DP_BATCH)] if fm is not None and data > 1 else order
            setup = setup_gram_attention(cfg, 4, [(None, None)], device=DEVICE)
            states = [setup.init(torch.Generator().manual_seed(121 + i)) for i in range(k)]
            run = {"local": local}
            if mesh is None:
                run["init"] = {f"fold{i}": to_jax_tree(m) for i, (m, _) in enumerate(states)}
            step = setup.foldwise_step(fm.data_axis if fm is not None else None)
            stacked = stack_fold_states([states[i] for i in local])
            losses, seconds = [], []
            kernels.reset_launch_counts()
            for st in range(PFM_STEPS):
                batches = [{"image": u8[st][i][rows], "label": labels[st][i][rows]}
                           for i in local]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step(stacked, batches, [True] * len(local)).cpu().tolist())
                seconds.append(time.perf_counter() - t0)
                if st == 0:
                    unstack_fold_state(stacked, [states[i] for i in local])
                    run["tree1"] = {f"fold{i}": to_jax_tree(states[i][0]) for i in local}
            run["launches"] = kernels.launch_counts()
            unstack_fold_state(stacked, [states[i] for i in local])
            if fm is not None:
                broadcast_fold_states(fm, states)
            run["trees"] = {f"fold{i}": to_jax_tree(m) for i, (m, _) in enumerate(states)}
            digest = hashlib.sha256()
            for i in range(k):
                for v in _flat_tree(run["trees"][f"fold{i}"]).values():
                    digest.update(np.ascontiguousarray(v).tobytes())
            run.update(losses=losses, seconds=seconds, digest=digest.hexdigest(),
                       case_s=time.perf_counter() - t_case)
            out[f"k{k}"] = run
            del states, stacked, step, setup
    return out


def _check_model_axis(ranks, trees, one, spread, launches_total: dict, smi: str) -> dict:
    """The model-axis cases (MA_CASES) of the ranks against the one-rank
    family-2 run ``one`` and its own spread ``spread`` (rows reversed)."""
    stages = F2T_TRUNCATE - 4
    own1 = _tree_gaps(spread["tree1"], one["tree1"], one["init"])
    limit1_moves = max(PF_TOL_MOVE, DP_SPREAD * own1["moves"])
    one_ips = DP_BATCH * (MA_STEPS - 1) / sum(one["seconds"][1:MA_STEPS])
    out = {}
    for name, mesh_name, factory in MA_CASES:
        r0 = ranks[0]["model_axis"][name]
        gaps1 = _tree_gaps(trees[name], one["tree1"], one["init"])
        gaps1["loss"] = abs(r0["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        later = [abs(a - b) / abs(b) for a, b in zip(r0["losses"][1:], one["losses"][1:])]
        per_rank = [rk["model_axis"][name]["launches"] for rk in ranks]
        want = {k: 0 for k in per_rank[0]}
        want.update({"pooled_gram_fwd": stages * MA_STEPS, "pooled_gram_bwd": stages * MA_STEPS})
        for rk_launches in per_rank:
            for k, v in rk_launches.items():
                launches_total[k] += v
        same = all(rk["model_axis"][name]["replicated_digest"] == r0["replicated_digest"]
                   and rk["model_axis"][name]["whole_digest"] == r0["whole_digest"]
                   and rk["model_axis"][name]["losses"] == r0["losses"] for rk in ranks)
        ips = DP_BATCH * (MA_STEPS - 1) / sum(r0["seconds"][1:])
        peaks = [rk["model_axis"][name]["peak_bytes"] for rk in ranks]
        stored = [rk["model_axis"][name]["stored_bytes"] for rk in ranks]
        print(f"[data_parallel] model axis {name} ({factory} on the {mesh_name} mesh), first "
              f"step against one rank: loss {gaps1['loss']:.2e}, params {gaps1['params']:.2e}, "
              f"stats {gaps1['stats']:.2e} (tol {DP_TOL}), moves {gaps1['moves']:.2e} (tol "
              f"{limit1_moves:.2e}); the later steps' losses {r0['losses'][1:]} against one "
              f"rank's {one['losses'][1:MA_STEPS]} (relative {[f'{x:.2e}' for x in later]}, "
              f"printed, not gated); replicated leaves and gathered trees bit-equal on the ranks "
              f"{same}; launches per rank {per_rank}; {ips:.1f} images/s global over steps 2-"
              f"{MA_STEPS} (one rank {one_ips:.1f}); peak device memory a rank "
              f"{[round(p / 2**20, 1) if p else p for p in peaks]} MiB; stored a rank: parameters "
              f"{[round(b['params'] / 2**20, 3) for b in stored]} MiB, momentum "
              f"{[round(b['state'] / 2**20, 3) for b in stored]} MiB, of the whole model's "
              f"{r0['whole_bytes']['params'] / 2**20:.3f} MiB each; "
              f"{max(rk['model_axis'][name]['case_s'] for rk in ranks):.1f} s ({smi})")
        _require(all(gaps1[k] <= DP_TOL for k in ("loss", "params", "stats"))
                 and gaps1["moves"] <= limit1_moves,
                 f"model axis {name}'s first step within {DP_TOL} of one rank's")
        _require(same, f"model axis {name}: the replicated leaves bit-equal on every rank")
        _require(all(rl == want for rl in per_rank),
                 f"each rank's launches in model axis {name}: {per_rank} (want {want})")
        if factory == "fsdp":
            _require(all(b["params"] * DP_RANKS <= r0["whole_bytes"]["params"] * 1.01
                         and b["state"] * DP_RANKS <= r0["whole_bytes"]["state"] * 1.01
                         for b in stored), "FSDP keeps about 1/N of the parameters a rank")
        out[name] = {"losses": r0["losses"], "one_rank_losses": one["losses"][:MA_STEPS],
                     "first_step": gaps1, "later_loss_gaps": later,
                     "launches_per_rank": per_rank,
                     "images_per_s": ips, "one_rank_images_per_s": one_ips,
                     "peak_bytes": peaks, "stored_bytes": stored,
                     "whole_bytes": r0["whole_bytes"], "seconds": r0["seconds"],
                     "case_s": [rk["model_axis"][name]["case_s"] for rk in ranks]}
    return out


def _rel_l2(got: dict, want: dict, keys) -> float:
    """Relative L2 gap of the leaves ``keys`` of two flat trees."""
    import numpy as np

    num = sum(float(np.sum(np.square(np.asarray(got[k], np.float64) - want[k]))) for k in keys)
    den = sum(float(np.sum(np.square(np.asarray(want[k], np.float64)))) for k in keys)
    return float(np.sqrt(num / max(den, 1e-300)))


def _check_sharded_ckpt(ranks, dp_dir: str, launches_total: dict, smi: str) -> dict:
    """The sharded-checkpoint case (see SC_STEPS): the ranks' reloads, their
    launches and bytes; then the first checkpoint, read whole, resumed on
    one device here: step 3 against the ranks' second checkpoint."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint import sharded_io
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.ops import kernels

    runs = [rk["sharded"] for rk in ranks]
    stages = F2T_TRUNCATE - 4
    want = {k: 0 for k in runs[0]["launches"]}
    want.update({"pooled_gram_fwd": stages * SC_STEPS, "pooled_gram_bwd": stages * SC_STEPS})
    per_rank = [run["launches"] for run in runs]
    for rl in per_rank:
        for k, v in rl.items():
            launches_total[k] += v
    mid, fin = os.path.join(dp_dir, "sharded_mid"), os.path.join(dp_dir, "sharded_fin")
    setup = _f2_defaults()
    u8, labels = _dp_batches()
    t0 = time.perf_counter()
    whole = sharded_io.load_sharded_pytree(mid)
    load_s = time.perf_counter() - t0

    def resumed(rows):
        """Step 3 on one device from the checkpoint, on the batch's
        ``rows``: (loss, trace tree, variables tree, launches)."""
        model, state = setup.init(torch.Generator().manual_seed(7))
        sharded_io.restore_state(model, state, whole)
        with _deterministic_cudnn():
            kernels.reset_launch_counts()
            model, state, loss = setup.train_step(model, state, u8[SC_STEPS - 1][rows],
                                                  labels[SC_STEPS - 1][rows])
            loss = float(loss)
            launches = kernels.launch_counts()
        return (loss, _flat_tree(to_jax_tree(model, state["trace"])),
                _flat_tree(to_jax_tree(model)), launches)

    rows = np.arange(DP_BATCH)
    loss, got_t, got_v, one_launches = resumed(rows)
    for k, v in one_launches.items():
        launches_total[k] += v
    own_t = _rel_l2(resumed(rows[::-1].copy())[1], got_t, got_t)  # one device's own spread
    limit_t = max(PF_TOL_MOVE, DP_SPREAD * own_t)
    final = sharded_io.load_sharded_pytree(fin)
    want_v, want_t = _flat_tree(final["variables"]), _flat_tree(final["opt"]["trace"])
    _require(got_v.keys() == want_v.keys() and got_t.keys() == want_t.keys(),
             "[data_parallel] the resumed state has the checkpoint's leaves")
    stats = [k for k in want_v if k.endswith(("/mean", "/var"))]
    gaps = {"loss": abs(loss - runs[0]["losses"][-1]) / abs(runs[0]["losses"][-1]),
            "params": _rel_l2(got_v, want_v, [k for k in want_v if k not in stats]),
            "stats": _rel_l2(got_v, want_v, stats), "trace": _rel_l2(got_t, want_t, want_t),
            "trace_own_spread": own_t}
    whole_bytes = sum(v.nbytes for v in _flat_tree(whole).values())
    written = [run["bytes_written"] for run in runs]
    one_want = {k: 0 for k in one_launches}
    one_want.update({"pooled_gram_fwd": stages, "pooled_gram_bwd": stages})
    print(f"[data_parallel] sharded checkpoint, family 2 b{DP_BATCH} f32 under FSDP on the two "
          f"ranks: the asynchronous save after step 2 reloaded bit-equal on each rank "
          f"{[run['reload_equal'] for run in runs]} (count {[run['count'] for run in runs]}); "
          f"bytes written a rank {written} of the whole state's {whole_bytes} (sum "
          f"{sum(written)}); seconds a rank: submit {[round(r['seconds']['submit'], 4) for r in runs]}, "
          f"submit to the end of step 3 {[round(r['seconds']['submit_to_step_end'], 3) for r in runs]}, "
          f"submit to commit {[round(r['seconds']['submit_to_commit'], 3) for r in runs]}, "
          f"synchronous save {[round(r['seconds']['sync_save'], 3) for r in runs]}, load "
          f"{[round(r['seconds']['load'], 3) for r in runs]}; the case "
          f"{[round(r['case_s'], 2) for r in runs]} s; launches per rank {per_rank}. Resumed on "
          f"one device (read whole in {load_s:.3f} s): step 3 against the ranks' loss "
          f"{gaps['loss']:.2e}, params {gaps['params']:.2e}, stats {gaps['stats']:.2e} (tol "
          f"{DP_TOL}), momentum {gaps['trace']:.2e} (tol {limit_t:.2e}: PF_TOL_MOVE or "
          f"{DP_SPREAD} times one device's own spread, the batch's rows reversed, {own_t:.2e}); "
          f"launches {one_launches} "
          f"({smi})")
    _require(all(run["reload_equal"] and run["count"] == SC_STEPS - 1 for run in runs),
             "[data_parallel] each rank's reload of the asynchronous save is bit-equal")
    _require(all(rl == want for rl in per_rank),
             f"[data_parallel] sharded checkpoint: each rank's launches {per_rank} (want {want})")
    _require(one_launches == one_want,
             f"[data_parallel] the resumed step's launches {one_launches} (want {one_want})")
    _require(all(gaps[k] <= DP_TOL for k in ("loss", "params", "stats"))
             and gaps["trace"] <= limit_t,
             f"[data_parallel] the checkpoint resumed on one device within {DP_TOL} of the ranks")
    _require(all(w < whole_bytes for w in written) and sum(written) >= whole_bytes,
             "[data_parallel] each rank wrote only its part of the state")
    return {"gaps": gaps, "bytes_written": written, "whole_bytes": whole_bytes,
            "seconds": [run["seconds"] for run in runs], "one_device_load_s": load_s,
            "launches_per_rank": per_rank, "one_device_launches": one_launches,
            "case_s": [run["case_s"] for run in runs]}


def _check_stride(ranks, tree0, data_root: str, launches_total: dict, smi: str) -> dict:
    """The loader-stride case (see SC_SEED): the ranks' step on their
    strides against one device on the two batches concatenated."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.ops import kernels

    batches = [_stride_batch(data_root, i, DP_RANKS) for i in range(DP_RANKS)]
    runs = [rk["stride"] for rk in ranks]
    same = all(run["indices"] == b["indices"].tolist() for run, b in zip(runs, batches))
    setup = _f2_defaults()
    images = np.concatenate([b["image"] for b in batches])
    labels = np.concatenate([b["label"] for b in batches])

    def one_device(rows):
        """One device's step on the concatenated batch's ``rows``: (loss,
        the init's tree, the tree after it, launches)."""
        model, opt = setup.init(torch.Generator().manual_seed(111))
        init = to_jax_tree(model)
        with _deterministic_cudnn():
            kernels.reset_launch_counts()
            model, opt, loss = setup.train_step(model, opt, images[rows], labels[rows])
            loss = float(loss)
            launches = kernels.launch_counts()
        return loss, init, to_jax_tree(model), launches

    rows = np.arange(len(labels))
    loss, init, tree, one_launches = one_device(rows)
    own = _tree_gaps(one_device(rows[::-1].copy())[2], tree, init)  # its own spread
    limit_moves = max(PF_TOL_MOVE, DP_SPREAD * own["moves"])
    gaps = _tree_gaps(tree0, tree, init)
    gaps["loss"] = abs(runs[0]["loss"] - loss) / abs(loss)
    stages = F2T_TRUNCATE - 4
    want = {k: 0 for k in one_launches}
    want.update({"pooled_gram_fwd": stages, "pooled_gram_bwd": stages})
    per_rank = [run["launches"] for run in runs]
    for rl in per_rank + [one_launches]:
        for k, v in rl.items():
            launches_total[k] += v
    print(f"[data_parallel] loader stride: HostLoader(process_index=rank, process_count=2) over "
          f"63 PNGs, b{DP_BATCH // DP_RANKS} a rank, the same rows as the parent's loaders "
          f"{same}, n_valid {[run['n_valid'] for run in runs]}; one family-2 step on the two "
          f"ranks against one device on the two batches concatenated: loss {gaps['loss']:.2e}, "
          f"params {gaps['params']:.2e}, stats {gaps['stats']:.2e} (tol {DP_TOL}), moves "
          f"{gaps['moves']:.2e} (tol {limit_moves:.2e}: PF_TOL_MOVE or {DP_SPREAD} times one "
          f"device's own spread, the rows reversed, {own['moves']:.2e}); launches per rank "
          f"{per_rank}, one device "
          f"{one_launches}; the case {[round(r['case_s'], 2) for r in runs]} s ({smi})")
    _require(same, "[data_parallel] the ranks' strides are the parent's loaders'")
    _require(all(gaps[k] <= DP_TOL for k in ("loss", "params", "stats"))
             and gaps["moves"] <= limit_moves,
             f"[data_parallel] the loader stride's step within {DP_TOL} of one device's")
    _require(all(rl == want for rl in per_rank) and one_launches == want,
             f"[data_parallel] loader stride: launches {per_rank}, {one_launches} (want {want})")
    return {"gaps": gaps, "moves_limit": limit_moves, "launches_per_rank": per_rank,
            "one_device_launches": one_launches, "case_s": [run["case_s"] for run in runs]}


def _check_fold_mesh(ranks, saved, one, spread, launches_total: dict, smi: str) -> dict:
    """The fold-mesh cases of the two ranks against one device's (see
    PFM_CASES): each fold's first step from the rank that holds it, every
    fold's last from rank 0's shared states, the launches of every rank,
    the digests, and the images/s of the two ranks beside one device's."""
    out = {}
    for k, fold, data in PFM_CASES:
        name = f"k{k}"
        ref, own = one[name], spread[name]
        runs = [rk["folds"][name] for rk in ranks]
        first, last, limits = {}, {}, {}
        for r, run in enumerate(runs):
            for j, i in enumerate(run["local"]):
                f = f"fold{i}"
                g = _tree_gaps(saved[r][name]["tree1"][f], ref["tree1"][f], ref["init"][f])
                g["loss"] = abs(run["losses"][0][j] - ref["losses"][0][i]) / abs(
                    ref["losses"][0][i])
                o = _tree_gaps(own["tree1"][f], ref["tree1"][f], ref["init"][f])
                first[f"rank{r}/{f}"] = g
                limits[f"rank{r}/{f}"] = {"moves": max(PF_TOL_MOVE, DP_SPREAD * o["moves"])}
                if f in last:  # a fold once: rank 0's shared state, its holder's loss
                    continue
                g = _tree_gaps(saved[0][name]["trees"][f], ref["trees"][f], ref["init"][f])
                g["loss"] = abs(run["losses"][-1][j] - ref["losses"][-1][i]) / abs(
                    ref["losses"][-1][i])
                o = _tree_gaps(own["trees"][f], ref["trees"][f], ref["init"][f])
                o["loss"] = abs(own["losses"][-1][i] - ref["losses"][-1][i]) / abs(
                    ref["losses"][-1][i])
                last[f] = g
                limits[f] = {key: max(DP_TOL if key != "moves" else PF_TOL_MOVE,
                                      DP_SPREAD * o[key])
                             for key in ("loss", "params", "stats", "moves")}
        stages = F2T_TRUNCATE - 4
        want = {kk: 0 for kk in runs[0]["launches"]}
        want.update({"pooled_gram_fwd": stages * PFM_STEPS, "pooled_gram_bwd": stages * PFM_STEPS})
        per_rank = [run["launches"] for run in runs]
        for rl in per_rank:
            for kk, v in rl.items():
                launches_total[kk] += v
        same = all(run["digest"] == runs[0]["digest"] for run in runs)
        ips = k * DP_BATCH * (PFM_STEPS - 1) / sum(runs[0]["seconds"][1:])
        one_ips = k * DP_BATCH * (PFM_STEPS - 1) / sum(ref["seconds"][1:])
        def worst(gaps, pick=max):  # each measure's worst (or tightest limit) over the folds
            keys = next(iter(gaps.values()))
            return {kk: f"{pick(g[kk] for g in gaps.values()):.2e}"
                    for kk in ("loss", "params", "stats", "moves") if kk in keys}

        print(f"[data_parallel] --parallel_folds, {k} folds on a fold {fold} x data {data} "
              f"mesh of the two ranks (b{DP_BATCH} a fold, {DP_BATCH // data} rows a rank), "
              f"family 2 f32 against one device, the worst fold: first step {worst(first)} "
              f"(tol {DP_TOL}; moves {worst({t: limits[t] for t in first}, min)}); after "
              f"{PFM_STEPS} steps {worst(last)} (tol {DP_TOL} or {DP_SPREAD} times one device's "
              f"own spread, the tightest: {worst({f: limits[f] for f in last}, min)}); shared "
              f"states bit-equal on both ranks {same}; launches per rank {per_rank}; "
              f"{ips:.1f} images/s on two ranks sharing the card against {one_ips:.1f} on one "
              f"(a correctness cell, not a scaling one) ({smi})")
        _require(all(g[kk] <= DP_TOL for g in first.values() for kk in ("loss", "params", "stats"))
                 and all(first[t]["moves"] <= limits[t]["moves"] for t in first),
                 f"[data_parallel] fold mesh {fold} x {data}: the first step within {DP_TOL} of "
                 "one device's")
        _require(all(last[f][kk] <= limits[f][kk] for f in last
                     for kk in ("loss", "params", "stats", "moves")),
                 f"[data_parallel] fold mesh {fold} x {data}: the last step within tolerance")
        _require(same, f"[data_parallel] fold mesh {fold} x {data}: the shared states agree")
        _require(all(rl == want for rl in per_rank),
                 f"[data_parallel] fold mesh {fold} x {data}: each rank's launches {per_rank} "
                 f"(want {want})")
        out[name] = {"mesh": [fold, data], "first_step": first, "last_step": last,
                     "limits": limits, "launches_per_rank": per_rank, "states_equal": same,
                     "images_per_s": ips, "one_device_images_per_s": one_ips}
    return out


def _eval_models():
    """The evaluation cases' models on the card, from seeded CPU weights
    through the JAX-layout tree (as the CLIs' loaders read a checkpoint):
    family 1 (full width), family 2 (truncate 8, S 7), family 3 (config
    defaults, norm "instance")."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
        load_jax_tree,
        to_jax_tree,
    )
    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        truncated_resnet50_init,
    )

    cfg3 = MultiPatchGANConfig(norm="instance")

    def f1(gen):
        return truncated_resnet50_init(gen, F1_TRUNCATE, F1_CLASSES, F1_DIM, device=DEVICE
                                       if gen is None else "cpu")

    def f2(gen):
        return gram_attention_init(gen, 8, 4, POOL_S, device=DEVICE if gen is None else "cpu")

    def f3(gen):
        return multiscale_test_init(gen, cfg3.patch_sizes, ndf=cfg3.ndf,
                                    num_classes=cfg3.num_classes,
                                    gram_matrix_dim=cfg3.gram_matrix_dim, norm="instance",
                                    device=DEVICE if gen is None else "cpu")

    models = {}
    for name, make, seed in (("f1", f1, 120), ("f2", f2, 121), ("f3", f3, 122)):
        seeded = to_jax_tree(make(torch.Generator().manual_seed(seed)))
        models[name] = load_jax_tree(make(None), seeded).eval()
    return models, cfg3


def _eval_loop_inputs(mesh, model):
    """The texture loop's gram_fn, this rank's starting noise and targets:
    rows of rank 0 (the first half) start near their targets (the Gram of
    the noise moved by DPE_NEAR), those of rank 1 far (their images')."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_gram_fn_gram_attention,
    )

    gram_fn = make_gram_fn_gram_attention(model, 8, layers=5)
    rng = np.random.RandomState(124)
    u8 = rng.randint(0, 256, (DPE_LOOP_BATCH, 224, 224, 3)).astype(np.uint8)
    noise = torch.randn((DPE_LOOP_BATCH, 224, 224, 3), generator=torch.Generator().manual_seed(125))
    local = (lambda x: x) if mesh is None else mesh.local  # noqa: E731
    images = eval_preprocess(torch.from_numpy(local(u8)).to(DEVICE))
    noise = local(noise).to(DEVICE)
    rows = np.arange(DPE_LOOP_BATCH) if mesh is None else mesh.rows(DPE_LOOP_BATCH)
    with torch.no_grad():
        near, far = gram_fn(noise + DPE_NEAR * images)[0], gram_fn(images)[0]
    pick = torch.as_tensor(rows < DPE_LOOP_BATCH // 2, device=DEVICE)[:, None, None]
    return gram_fn, noise, torch.where(pick, near, far)


def _eval_data(root: str) -> str:
    """The evaluation cases' ImageFolder: 63 random 256² PNGs under test/
    (16 a class, the last class one short), so a b32 pass over them ends
    on a batch with one pad row."""
    _image_folder(root, 16, seed=126)
    os.remove(os.path.join(root, "test", "sun", "img_015.png"))
    return root


def _eval_runs(mesh, threshold, data=None, out_dir=None) -> dict:
    """The data_parallel phase's evaluation cases on ``mesh`` (None: one
    rank), through the evaluation CLIs' task functions on the ImageFolder
    at ``data``, each loader ``cli/_common.eval_loader`` (on a mesh
    ``HostLoader(rows=)``: a rank decodes its rows of every batch alone):
    family 1's ``tasks/classification.evaluate_classification`` (the step
    ``run_classification_test`` runs: loss, probabilities, predictions,
    labels), ``tasks/embeddings.compute_embeddings_with_paths`` and
    ``tasks/inference.run_inference``; family 2's
    ``cli/test_gram_attention.run_classification`` (its JSON, written by
    rank 0 under ``out_dir``) and ``evaluate_classification`` on its
    forward; family 3's ``cli/test_multi_patchgan.evaluate``. Each case
    runs DPE_BATCHES batches, the last with one pad row, after a warm
    batch. Then the texture loop (``make_style_transfer_optimizer(mesh=)``)
    at ``threshold`` (None: one iteration at threshold 0, the rows' first
    losses, and nothing else). Each case: its gathered results, this
    rank's launches, its seconds."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli._common import eval_loader
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import (
        run_classification,
    )
    from heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan import evaluate
    from heuristique_style_transfer_code_tpu_torch.core.mesh import gather_valid
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply,
        truncated_moco_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.tasks.classification import (
        evaluate_classification,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.embeddings import (
        compute_embeddings_with_paths,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.inference import run_inference
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_style_transfer_optimizer,
    )

    models, cfg3 = _eval_models()
    out = {}
    if threshold is not None:
        index = ImageFolderIndex(os.path.join(data, "test"))
        f1, f2, f3 = models["f1"], models["f2"], models["f3"]

        def fwd1(m, x):
            return combined_apply(m.moco, m.classifier, x, F1_TRUNCATE)

        def fwd2(m, x):
            return gram_attention_apply(m, x, 8, POOL_S, 4)[1]

        def classified(res):
            return {"loss": float(res["loss"]), "probs": np.asarray(res["probs"]).tolist(),
                    "preds": np.asarray(res["preds"]).tolist(),
                    "labels": np.asarray(res["targets"]).tolist()}

        spread = index.samples[::4]  # every class among family 2's few rows
        cases = {
            "f1": (DPE_F1_BATCH, index.samples, lambda ld, s: classified(
                evaluate_classification(fwd1, f1, ld, 4, prob_threshold=0.0, mesh=mesh))),
            "f1_embeddings": (DPE_F1_BATCH, index.samples, lambda ld, s: dict(zip(
                ("embeddings", "labels", "paths"), (np.asarray(v).tolist() for v in
                                                    compute_embeddings_with_paths(
                                                        lambda m, x: truncated_moco_apply(
                                                            m.moco, x, F1_TRUNCATE),
                                                        f1, ld, s, mesh=mesh))))),
            "f1_inference": (DPE_F1_BATCH, None, lambda ld, s: {"probs": [
                [p["class_probabilities"][c] for c in index.classes] for p in run_inference(
                    fwd1, f1, os.path.join(data, "test"), index.classes,
                    os.path.join(out_dir, "f1_inference"), batch_size=DPE_F1_BATCH,
                    mesh=mesh)["predictions"]]}),
            "f2": (DPE_F2_BATCH, spread, lambda ld, s: run_classification(
                f2, ld, os.path.join(out_dir, "f2"), truncate=8, gram_matrix_size=POOL_S,
                num_classes=4, mesh=mesh)),  # its --compute_auc needs scikit-learn
            "f2_probs": (DPE_F2_BATCH, spread, lambda ld, s: classified(
                evaluate_classification(fwd2, f2, ld, 4, prob_threshold=0.0, mesh=mesh))),
            "f3": (DPE_F3_BATCH, index.samples, lambda ld, s: {
                k: np.asarray(v).tolist() for k, v in evaluate(
                    f3, ld, gram_matrix_dim=cfg3.gram_matrix_dim, norm="instance",
                    mesh=mesh).items() if k != "spans"}),
        }
        for name, (batch, samples, run) in cases.items():
            if samples is not None:
                samples = samples[:batch * DPE_BATCHES - 1]
                run(eval_loader(samples[:batch], batch, mesh, shuffle=False),
                    samples[:batch])  # cuDNN's plans
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = run(None if samples is None else eval_loader(samples, batch, mesh,
                                                               shuffle=False), samples)
            seconds = time.perf_counter() - t0
            out[name] = {**res, "launches": kernels.launch_counts(), "seconds": seconds,
                         "images_per_s": (batch * DPE_BATCHES - 1) / seconds}
    gram_fn, noise, targets = _eval_loop_inputs(mesh, models["f2"])
    iters = DPE_ITERS if threshold is not None else 1
    run = make_style_transfer_optimizer(gram_fn, 0.01, iters, threshold or 0.0, mesh=mesh)
    with _deterministic_cudnn():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, done, per = run(noise, [targets])
        (per,) = gather_valid(mesh, [per])
        out["loop"] = {"iters": int(done), "per": per.tolist(),
                       "launches": kernels.launch_counts(), "seconds": time.perf_counter() - t0}
        if mesh is None and threshold is not None:
            # one rank on the two ranks' blocks (b2 each, the loop's end over
            # both), twice: the ranks' arithmetic without their collectives,
            # and its own run-to-run spread
            import functools

            from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
                drive_masked_adam_blocks,
                make_per_image_gram_loss,
                masked_adam_step,
            )

            loss = make_per_image_gram_loss(gram_fn)
            halves = (slice(0, DPE_LOOP_BATCH // 2), slice(DPE_LOOP_BATCH // 2, DPE_LOOP_BATCH))
            steps = [functools.partial(masked_adam_step, lambda x, t=targets[h]: loss(x, t),
                                       0.01, threshold) for h in halves]
            for key in ("loop_blocks", "loop_blocks_again"):
                _, done, per = drive_masked_adam_blocks(steps, [noise[h] for h in halves],
                                                        DPE_ITERS)
                out[key] = {"iters": int(done), "per": torch.cat(per).tolist()}
    return out


def _dp_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """A spawned gloo rank of the data_parallel phase on card 0: the runs of
    ``_dp_runs`` on its mesh, then its results (rank 0's trees, every
    rank's losses, launches, seconds and a checksum of each tree) in
    ``out_dir``."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.core.device import resolve_device
    from heuristique_style_transfer_code_tpu_torch.core.mesh import create_mesh
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        initialize_distributed,
        shutdown_distributed,
    )

    t0 = time.perf_counter()
    resolve_device(DEVICE)
    initialize_distributed(rank, world, init_method, backend="gloo")
    try:
        card = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)
        mesh = create_mesh(world, devices=[card] * world)
        start_s = time.perf_counter() - t0
        runs = _dp_runs(mesh, profile=True)
        with open(os.path.join(out_dir, "eval_threshold.json")) as f:
            spec = json.load(f)
        evals = _eval_runs(mesh, spec["threshold"], spec["data"],
                           os.path.join(out_dir, "eval_two_ranks"))
        t_folds = time.perf_counter()
        folds = _fold_mesh_runs(mesh)
        folds_s = time.perf_counter() - t_folds
        save_pytree_npz({name: {"tree1": run.pop("tree1"), "trees": run.pop("trees")}
                         for name, run in folds.items()},
                        os.path.join(out_dir, f"rank{rank}_fold_trees.npz"))
        model_axis = _model_axis_runs(mesh)
        if rank == 0:
            save_pytree_npz({name: run["tree1"] for name, run in model_axis.items()},
                            os.path.join(out_dir, "rank0_model_axis_trees.npz"))
        for run in model_axis.values():
            del run["tree1"]
        sharded = _sharded_ckpt_runs(mesh, out_dir)
        stride = _stride_run(mesh, spec["data"])
        if rank == 0:
            save_pytree_npz(stride["tree"], os.path.join(out_dir, "rank0_stride_tree.npz"))
        del stride["tree"]
        trees = {"final": {}, "step1": {}}
        for name, run in runs.items():
            run.pop("init")
            trees["step1"][name] = run.pop("tree1")
            tree = run.pop("tree")
            trees["final"][name] = tree
            run["checksum"] = float(sum(np.float64(np.sum(v, dtype=np.float64))
                                        for v in _flat_tree(tree).values()))
        if rank == 0:
            save_pytree_npz(trees, os.path.join(out_dir, "rank0_trees.npz"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "world": world, "backend": "gloo",
                       "staged_on_host": mesh.stage_on_host, "start_s": start_s,
                       "runs": runs, "evals": evals, "folds": folds, "folds_s": folds_s,
                       "model_axis": model_axis, "sharded": sharded, "stride": stride}, f,
                      default=str)
    finally:
        shutdown_distributed()


def _flat_tree(tree, prefix: str = "") -> dict:
    """{path: numpy leaf} of a JAX-layout tree (None leaves dropped)."""
    import numpy as np

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_tree(v, f"{prefix}/{i}"))
        return out
    return {} if tree is None else {prefix: np.asarray(tree)}


def _tree_gaps(got, want, init) -> dict:
    """Whole-tree relative L2 gaps of the parameters and of the batch-norm
    statistics (values), and of the parameters' moves from ``init``, and
    the worst move gap of a leaf that moved (printed, not gated)."""
    import numpy as np

    g, w, i = _flat_tree(got), _flat_tree(want), _flat_tree(init)
    _require(g.keys() == w.keys(), "the two runs' trees have the same leaves")
    stats = [k for k in w if k.endswith(("/mean", "/var"))]
    params = [k for k in w if k not in stats]

    def rel(keys, f):
        num = sum(float(np.sum(np.square(f(g[k], k) - f(w[k], k)))) for k in keys)
        den = sum(float(np.sum(np.square(f(w[k], k)))) for k in keys)
        return float(np.sqrt(num / max(den, 1e-300)))

    value = lambda a, k: a.astype(np.float64)  # noqa: E731
    move = lambda a, k: a.astype(np.float64) - i[k]  # noqa: E731
    total = np.sqrt(sum(float(np.sum(np.square(move(w[k], k)))) for k in params))
    moved = [k for k in params  # a bias ahead of a norm has no gradient and moves by rounding
             if np.linalg.norm(move(w[k], k)) > 1e-4 * total] or params
    worst = max(moved, key=lambda k: rel([k], move))
    return {"params": rel(params, value), "stats": rel(stats, value) if stats else 0.0,
            "moves": rel(params, move), "worst_leaf": worst,
            "worst_leaf_move": rel([worst], move)}


def _check_evals(ranks, one, first, threshold: float, launches_total: dict, smi: str,
                 dp_dir: str) -> dict:
    """The evaluation cases of the two ranks against one rank's (see
    DPE_*): every rank's gathered results, its exact launches, and the
    images/s of the two ranks (rank 0's wall clock) beside one rank's."""
    import numpy as np

    out = {"threshold": threshold, "first_losses": first.tolist()}
    k2 = {"pooled_gram_fwd": 4 * DPE_BATCHES}
    want = {"f1": {}, "f1_embeddings": {}, "f1_inference": {}, "f2": k2, "f2_probs": k2,
            "f3": {"instance_norm_fwd": F3_NORMS * DPE_BATCHES,
                   "gram_fwd": F3_GRAMS * DPE_BATCHES},
            "loop": {"gram_fwd": DPE_ITERS, "gram_bwd": DPE_ITERS}}
    for name in want:
        ref = one[name]
        per_rank = [rk["evals"][name]["launches"] for rk in ranks]
        for rk_launches in per_rank:
            for k, v in rk_launches.items():
                launches_total[k] += v
        expect = {k: 0 for k in per_rank[0]}
        expect.update(want[name])
        _require(all(rl == expect for rl in per_rank),
                 f"[data_parallel] eval {name}: each rank's launches {per_rank} (want {expect})")
        if name == "loop":
            iters = [rk["evals"][name]["iters"] for rk in ranks]
            got = np.asarray(ranks[0]["evals"][name]["per"])
            want_per, blocks = np.asarray(ref["per"]), np.asarray(one["loop_blocks"]["per"])

            def rel(a, b):
                return float(np.max(np.abs(a - b) / np.abs(b)))

            again = np.asarray(one["loop_blocks_again"]["per"])
            gap, like, spread = rel(got, want_per), rel(got, blocks), rel(blocks, want_per)
            own = rel(again, blocks)
            like_limit = max(DPE_TOL, DP_SPREAD * own)
            limit = max(DPE_TOL, DP_SPREAD * max(spread, own))
            print(f"[data_parallel] eval texture loop b{DPE_LOOP_BATCH} (layers 5, cuDNN's "
                  f"deterministic algorithms): first losses {first.tolist()}, threshold "
                  f"{threshold:.3e}; iterations per rank {iters} (one rank {ref['iters']}, one "
                  f"rank on the ranks' b2 blocks {one['loop_blocks']['iters']}); final losses "
                  f"{got.tolist()}: against one rank on the same b2 blocks {like:.2e} (tol "
                  f"{like_limit:.2e}: DPE_TOL or {DP_SPREAD} times that run's own run-to-run "
                  f"gap, {own:.2e}), against one rank at b{DPE_LOOP_BATCH} {gap:.2e} (tol "
                  f"{limit:.2e}: or {DP_SPREAD} times the b2 blocks' gap to it, {spread:.2e}); "
                  f"launches per rank {per_rank} ({smi})")
            _require(iters == [ref["iters"]] * len(ranks) == [DPE_ITERS] * len(ranks)
                     and one["loop_blocks"]["iters"] == DPE_ITERS and like <= like_limit
                     and gap <= limit,
                     "[data_parallel] the texture loop's two ranks end as one rank does")
            out[name] = {"iters": iters, "per": got.tolist(), "one_rank_per": ref["per"],
                         "one_rank_blocks_per": blocks.tolist(), "gap": gap,
                         "gap_same_blocks": like, "blocks_spread": spread,
                         "blocks_own_spread": own, "limit": limit, "like_limit": like_limit,
                         "launches_per_rank": per_rank}
            continue
        got = ranks[0]["evals"][name]
        same = all(rk["evals"][name] == {**got, "launches": rk["evals"][name]["launches"],
                                         "seconds": rk["evals"][name]["seconds"],
                                         "images_per_s": rk["evals"][name]["images_per_s"]}
                   for rk in ranks)
        checks, gaps = [], {}
        if name == "f2":  # the family-2 CLI's JSON: its metrics, and rank 0 wrote it
            path = os.path.join(dp_dir, "eval_two_ranks", "f2", "classification_results.json")
            with open(path) as f:
                written = json.load(f)
            checks.append(all(written[k] == got[k] for k in written))
            for k in ("precision", "recall", "f1_score"):
                checks.append(got[k] == ref[k])
        elif name == "f1_embeddings":
            e, w = np.asarray(got["embeddings"]), np.asarray(ref["embeddings"])
            gaps["embeddings_rel"] = float(np.abs(e - w).max() / np.abs(w).max())
            checks += [got["labels"] == ref["labels"], got["paths"] == ref["paths"]]
        else:
            p, w = np.asarray(got["probs"]), np.asarray(ref["probs"])
            gaps["probs"] = float(np.abs(p - w).max())
            checks.append(bool((p.argmax(1) == w.argmax(1)).all()))
            if "loss" in got:
                gaps["loss_rel"] = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
            checks += [got[k] == ref[k] for k in ("preds", "labels") if k in got]
        ips = got["images_per_s"]
        rows = DPE_F2_BATCH if name.startswith("f2") else DPE_F1_BATCH
        print(f"[data_parallel] eval {name}: {rows * DPE_BATCHES - 1} valid rows in "
              f"{DPE_BATCHES} batches, two ranks vs one: gaps "
              f"{ {k: f'{v:.3e}' for k, v in gaps.items()} } (tol {DPE_TOL}), predictions, "
              f"labels, argmax, paths or metrics equal {all(checks)}, ranks hold the same "
              f"{same}; launches per rank {per_rank}; {ips:.1f} images/s on two ranks sharing "
              f"the card against {ref['images_per_s']:.1f} on one (a correctness cell, not a "
              f"scaling one) ({smi})")
        _require(all(v <= DPE_TOL for v in gaps.values()) and all(checks) and same,
                 f"[data_parallel] eval {name}: two ranks answer as one")
        out[name] = {"gaps": gaps, "equal": all(checks), "launches_per_rank": per_rank,
                     "images_per_s": ips, "one_rank_images_per_s": ref["images_per_s"]}
    return out


def phase_data_parallel(kernels, tmp: str, timings: dict, smi: str) -> dict:
    """Data-parallel training on the one card (see the module docstring):
    (a) the one-rank runs of ``_dp_runs`` here; (b) DP_RANKS gloo ranks
    spawned on card 0 (``parallel.multihost.launch``, ``_dp_rank``), held
    to (a) and ZeRO-1 to plain data parallelism, with each rank's launches,
    state bytes, images/s and collectives' ms; (c) one NCCL rank here (a
    one-rank group: the data-parallel path with real collectives), one
    family-3 "instance" step bit-equal to the plain step and one family-2
    step within DP_TOL."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import load_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.core.mesh import create_mesh
    from heuristique_style_transfer_code_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    out = {"power": smi}
    one = _dp_runs(None)
    spread = _dp_runs(None, reverse=True, names=("f2", "f3_instance"))
    dp_dir = os.path.join(tmp, "data_parallel")
    os.makedirs(dp_dir, exist_ok=True)
    first = np.asarray(_eval_runs(None, None)["loop"]["per"])
    half = DPE_LOOP_BATCH // 2
    _require(first[:half].max() * 100 < first[half:].min(),
             f"the texture loop's rank-0 rows start near their targets: {first.tolist()}")
    threshold = float(np.sqrt(first[:half].max() * first[half:].min()))
    data = _eval_data(os.path.join(dp_dir, "eval_data"))
    with open(os.path.join(dp_dir, "eval_threshold.json"), "w") as f:
        json.dump({"threshold": threshold, "data": data}, f)
    one_eval = _eval_runs(None, threshold, data, os.path.join(dp_dir, "eval_one_rank"))
    t0 = time.perf_counter()
    one_folds = _fold_mesh_runs(None)
    spread_folds = _fold_mesh_runs(None, reverse=True)
    out["fold_mesh_one_device_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multihost.launch(DP_RANKS, None, [], target=_dp_rank, target_args=(dp_dir,),
                     rendezvous_dir=tmp, deadline_s=DP_TIMEOUT_S)
    out["spawn_and_runs_s"] = time.perf_counter() - t0
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(dp_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    saved = load_pytree_npz(os.path.join(dp_dir, "rank0_trees.npz"))
    trees, trees1 = saved["final"], saved["step1"]
    stages = F2T_TRUNCATE - 4
    want_launches = {"f2": {"pooled_gram_fwd": stages * DP_STEPS,
                            "pooled_gram_bwd": stages * DP_STEPS},
                     "f3_instance": {"instance_norm_fwd": F3_NORMS * DP_STEPS,
                                     "instance_norm_bwd": F3_NORMS * DP_STEPS}}
    want_launches["f2_zero1"] = want_launches["f2"]
    print(f"[data_parallel] backend gloo, world size {DP_RANKS}, both ranks on cuda:0, "
          f"collectives staged through host memory: {ranks[0]['staged_on_host']}; spawn, "
          f"start and runs {out['spawn_and_runs_s']:.1f} s ({smi})")
    launches_total = {k: 0 for k in kernels.launch_counts()}
    for name in ("f2", "f2_zero1", "f3_instance"):
        ref = one[name]
        r0 = ranks[0]["runs"][name]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"]))
        gaps = _tree_gaps(trees[name], ref["tree"], ref["init"])
        gaps1 = _tree_gaps(trees1[name], ref["tree1"], ref["init"])
        gaps1["loss"] = abs(r0["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
        other = spread[name.replace("_zero1", "")]
        own = _tree_gaps(other["tree"], ref["tree"], ref["init"])
        own["loss"] = max(abs(a - b) / abs(b) for a, b in zip(other["losses"], ref["losses"]))
        own1 = _tree_gaps(other["tree1"], ref["tree1"], ref["init"])
        limit1_moves = max(PF_TOL_MOVE, DP_SPREAD * own1["moves"])
        limit = {k: max(DP_TOL if k != "moves" else PF_TOL_MOVE, DP_SPREAD * own[k])
                 for k in ("loss", "params", "stats", "moves")}
        same = all(rk["runs"][name]["losses"] == r0["losses"]
                   and rk["runs"][name]["checksum"] == r0["checksum"] for rk in ranks)
        per_rank = [rk["runs"][name]["launches"] for rk in ranks]
        want = {k: 0 for k in per_rank[0]}
        want.update(want_launches[name])
        for rk_launches in per_rank:
            for k, v in rk_launches.items():
                launches_total[k] += v
        step_s = r0["seconds"][1:]
        ips = DP_BATCH * len(step_s) / sum(step_s)
        one_ips = DP_BATCH * len(step_s) / sum(ref["seconds"][1:])
        print(f"[data_parallel] {name}, first step against one rank: loss {gaps1['loss']:.2e}, "
              f"params {gaps1['params']:.2e}, stats {gaps1['stats']:.2e} (tol {DP_TOL}), moves "
              f"{gaps1['moves']:.2e} (tol {limit1_moves:.2e}; worst leaf {gaps1['worst_leaf']} "
              f"{gaps1['worst_leaf_move']:.2e}); one rank's own spread (rows reversed): params "
              f"{own1['params']:.2e}, stats {own1['stats']:.2e}, moves {own1['moves']:.2e}")
        print(f"[data_parallel] {name}: losses {r0['losses']} (one rank {ref['losses']}, "
              f"worst {loss_gap:.2e}); trees vs one rank: params {gaps['params']:.2e}, stats "
              f"{gaps['stats']:.2e}, moves {gaps['moves']:.2e} (worst leaf "
              f"{gaps['worst_leaf']} {gaps['worst_leaf_move']:.2e}); one rank's own spread "
              f"(rows reversed): loss {own['loss']:.2e}, params {own['params']:.2e}, stats "
              f"{own['stats']:.2e}, moves {own['moves']:.2e}; ranks equal {same}; "
              f"launches per rank {per_rank}; {ips:.1f} images/s global over steps 2-"
              f"{DP_STEPS} (one rank {one_ips:.1f}) ({smi})")
        _require(all(gaps1[k] <= DP_TOL for k in ("loss", "params", "stats"))
                 and gaps1["moves"] <= limit1_moves,
                 f"data-parallel {name}'s first step within {DP_TOL} of one rank's")
        _require(loss_gap <= limit["loss"] and all(gaps[k] <= limit[k]
                                                   for k in ("params", "stats", "moves")),
                 f"data-parallel {name} within tolerance of one rank: {limit}")
        _require(same, f"every rank ends {name} with the same losses and weights")
        _require(all(rl == want for rl in per_rank),
                 f"each rank's launches in {name}: {per_rank} (want {want})")
        out[name] = {"losses": r0["losses"], "one_rank_losses": ref["losses"],
                     "loss_gap": loss_gap, **gaps, "first_step": gaps1,
                     "first_step_spread": own1,
                     "one_rank_spread": own, "limit": limit,
                     "launches_per_rank": per_rank,
                     "images_per_s": ips, "one_rank_images_per_s": one_ips,
                     "state_bytes": r0.get("state_bytes"),
                     "one_rank_state_bytes": ref.get("state_bytes")}
    z = _tree_gaps(trees["f2_zero1"], trees["f2"], one["f2"]["init"])
    zb = ranks[0]["runs"]["f2_zero1"]["state_bytes"]
    whole = one["f2"]["state_bytes"]["rank_total"]
    print(f"[data_parallel] ZeRO-1 against plain data parallelism: params {z['params']:.2e}, "
          f"moves {z['moves']:.2e}; a rank's momentum {zb['rank_total'] / 2**20:.2f} MiB "
          f"({zb['rank_replicated'] / 2**20:.3f} MiB of it replicated) of "
          f"{whole / 2**20:.2f} MiB replicated")
    _require(z["params"] <= DP_TOL_ZERO1 and z["moves"] <= DP_TOL_ZERO1,
             "ZeRO-1 equals plain data parallelism")
    _require(zb["rank_split"] <= (whole - zb["rank_replicated"]) / DP_RANKS,
             "ZeRO-1 keeps 1/N of the split leaves a rank")
    out["zero1_vs_dp"] = z
    f2r0 = ranks[0]["runs"]["f2"]
    coll = f2r0.get("collectives_ms", {})
    print(f"[data_parallel] one profiled family-2 b{DP_BATCH} step on rank 0, the collectives' "
          f"host ms (gloo, staged through host memory, waits for the other rank included): "
          f"{ {k: round(v, 3) for k, v in coll.items()} }; the step's device busy "
          f"{f2r0.get('profiled_step_device_busy_ms', 0.0):.3f} ms, the timed steps "
          f"{[round(x * 1e3, 1) for x in f2r0['seconds']]} ms ({smi})")
    out["collectives_ms"] = coll
    out["profiled_step_device_busy_ms"] = f2r0.get("profiled_step_device_busy_ms")
    out["ranks_start_s"] = [rk["start_s"] for rk in ranks]

    out["evals"] = _check_evals(ranks, one_eval, first, threshold, launches_total, smi, dp_dir)
    saved = [load_pytree_npz(os.path.join(dp_dir, f"rank{r}_fold_trees.npz"))
             for r in range(DP_RANKS)]
    out["fold_mesh"] = _check_fold_mesh(ranks, saved, one_folds, spread_folds, launches_total,
                                        smi)
    out["fold_mesh"]["ranks_s"] = [rk["folds_s"] for rk in ranks]
    out["fold_mesh"]["one_device_s"] = out.pop("fold_mesh_one_device_s")
    cases = {f"{tag} {n}": [round(r["case_s"], 2), [round(x, 3) for x in r["seconds"]]]
             for tag, runs in (("one", one_folds), ("reversed", spread_folds))
             for n, r in runs.items()}
    print(f"[data_parallel] the fold-mesh cases: {out['fold_mesh']['one_device_s']:.1f} s of one-"
          f"device references (a case's seconds and its steps': {cases}), "
          f"{max(out['fold_mesh']['ranks_s']):.1f} s on the ranks")
    out["model_axis"] = _check_model_axis(ranks, load_pytree_npz(
        os.path.join(dp_dir, "rank0_model_axis_trees.npz")), one["f2"], spread["f2"],
        launches_total, smi)
    out["sharded_checkpoint"] = _check_sharded_ckpt(ranks, dp_dir, launches_total, smi)
    out["loader_stride"] = _check_stride(ranks, load_pytree_npz(
        os.path.join(dp_dir, "rank0_stride_tree.npz")), data, launches_total, smi)

    # (c) one NCCL rank: the data-parallel path with NCCL's collectives
    from heuristique_style_transfer_code_tpu_torch.config.schema import (
        GramAttentionConfig,
        MultiPatchGANConfig,
    )
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.train.factories import (
        setup_gram_attention,
        setup_multi_patchgan,
    )

    rng = np.random.RandomState(112)
    u8 = rng.randint(0, 256, (DP_BATCH, 256, 256, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, (DP_BATCH,)).astype(np.int32)
    multihost.initialize_distributed(0, 1, "file://" + os.path.join(tmp, "nccl_rendezvous"),
                                     backend="nccl")
    try:
        mesh = create_mesh(1)
        nccl = {}
        kernels.reset_launch_counts()
        with _deterministic_cudnn():
            for name in ("f3_instance", "f2"):
                result = []
                for m in (None, mesh):
                    if name == "f2":
                        cfg = GramAttentionConfig(batch_size=DP_BATCH, lr=DP_LR,
                                                  truncate_layer=F2T_TRUNCATE,
                                                  gram_matrix_size=F2T_S, seed=0)
                        setup = setup_gram_attention(cfg, 4, [(None, None)], device=DEVICE,
                                                     mesh=m)
                    else:
                        cfg = MultiPatchGANConfig(batch_size=DP_BATCH, lr=DP_LR,
                                                  norm="instance", seed=0)
                        setup = setup_multi_patchgan(cfg, 4, [(None, None)], device=DEVICE,
                                                     mesh=m)
                    model, opt = setup.init(torch.Generator().manual_seed(113))
                    init = to_jax_tree(model)
                    model, opt, loss = setup.train_step(model, opt, u8, labels)
                    result.append((float(loss), to_jax_tree(model)))
                (plain_loss, plain), (dp_loss, dp) = result
                gaps = _tree_gaps(dp, plain, init)
                diff = [k for k, v in _flat_tree(plain).items()
                        if not np.array_equal(v, _flat_tree(dp)[k])]
                nccl[name] = {"loss": dp_loss, "plain_loss": plain_loss, **gaps,
                              "leaves_differ": len(diff)}
                print(f"[data_parallel] one NCCL rank (backend {mesh.backend}), {name}: loss "
                      f"{dp_loss} against the plain step's {plain_loss}; params "
                      f"{gaps['params']:.2e}, stats {gaps['stats']:.2e}, {len(diff)} leaves "
                      "differ")
                if name == "f3_instance":  # no batch norm: the same ops, sums of one rank
                    _require(not diff and dp_loss == plain_loss,
                             "one NCCL rank's family-3 step equals the plain step")
                else:
                    _require(abs(dp_loss - plain_loss) <= DP_TOL * abs(plain_loss)
                             and gaps["params"] <= DP_TOL and gaps["stats"] <= DP_TOL,
                             "one NCCL rank's family-2 step within DP_TOL of the plain step")
        for k, v in kernels.launch_counts().items():
            launches_total[k] += v
    finally:
        multihost.shutdown_distributed()
    out["nccl"] = nccl
    out["launches"] = launches_total
    timings["data_parallel_phase_s"] = time.perf_counter() - t_phase
    print(f"[data_parallel] {timings['data_parallel_phase_s']:.2f} s in all")
    return out


def _gap(got, want) -> float:
    """``_rel_errs``' max of two tensors on the card."""
    return _rel_errs(got.float().cpu(), want.float().cpu())[0]


def _sp_kernel_rows(kin, peaks) -> list:
    """The four banded K3/K3' entry points at SP_IN_SHAPES' bands (module
    docstring); a row per (shape, dtype) and entry point: max_abs_err
    against the plain version, relative error of the whole map against the
    unbanded kernels, ms, plain_ms, bound_ms (bytes), library_ms
    (``torch.var_mean`` for the statistics; no single library call
    computes the other three)."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.parallel.spatial import _chan_merge, row_split

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(41)
    for shape in SP_IN_SHAPES:
        b, h, w, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            dname = "float32" if dtype == torch.float32 else "bfloat16"
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            bands_ = [(a * w, e * w) for a, e in row_split(h, SP_RANKS)]
            flat, dflat = x.reshape(b, h * w, c), dy.reshape(b, h * w, c)
            xs = [flat[:, a:e].contiguous() for a, e in bands_]
            dys = [dflat[:, a:e].contiguous() for a, e in bands_]
            stats = [kin.instance_norm_band_stats(t) for t in xs]
            errs = {"instance_norm_band_stats": max(
                _gap(st, kin.instance_norm_band_stats_plain(t)) for st, t in zip(stats, xs))}
            n, mean, m2 = _chan_merge(stats).unbind(-1)
            coef = torch.stack([mean, torch.rsqrt(m2 / n + kin.EPS), 1.0 / n,
                                torch.zeros_like(n)], dim=-1).contiguous()
            ys = [kin.instance_norm_band_apply(t, coef, True) for t in xs]
            errs["instance_norm_band_apply"] = max(
                _gap(y, kin.instance_norm_band_apply_plain(t, coef, True))
                for y, t in zip(ys, xs))
            sums = [kin.instance_norm_band_bwd_reduce(t, d, coef, True, y)
                    for t, d, y in zip(xs, dys, ys)]
            errs["instance_norm_band_bwd_reduce"] = max(
                _gap(sm, kin.instance_norm_band_bwd_reduce_plain(t, d, coef, True, y))
                for sm, t, d, y in zip(sums, xs, dys, ys))
            total = sums[0] + sums[1]
            dxs = [kin.instance_norm_band_bwd_apply(t, d, coef, total, True, y)
                   for t, d, y in zip(xs, dys, ys)]
            errs["instance_norm_band_bwd_apply"] = max(
                _gap(dx, kin.instance_norm_band_bwd_apply_plain(t, d, coef, total, True, y))
                for dx, t, d, y in zip(dxs, xs, dys, ys))
            ones = torch.ones((b, c), device="cuda")
            whole_y = kin.instance_norm_fwd(flat, ones, torch.zeros_like(ones), relu=True)
            whole_dx = kin.instance_norm_bwd(flat, dflat, ones, torch.zeros_like(ones),
                                             relu=True, y=whole_y)[0]
            y_gap = _gap(torch.cat(ys, 1), whole_y)
            dx_gap = _gap(torch.cat(dxs, 1), whole_dx)
            tol = SP_TOL_IN[dname]
            _require(all(e <= tol for e in errs.values()) and y_gap <= tol and dx_gap <= tol,
                     f"[spatial] banded K3/K3' at {shape} {dname}: {errs}, whole map y "
                     f"{y_gap:.3g}, dx {dx_gap:.3g} (tol {tol})")
            x0, d0, y0, es = xs[0], dys[0], ys[0], x.element_size()
            nb = x0.numel() * es
            calls = {
                "instance_norm_band_stats": (lambda: kin.instance_norm_band_stats(x0),
                                             lambda: kin.instance_norm_band_stats_plain(x0),
                                             lambda: torch.var_mean(x0, dim=1, correction=0),
                                             nb + b * c * 12),
                "instance_norm_band_apply": (lambda: kin.instance_norm_band_apply(x0, coef, True),
                                             lambda: kin.instance_norm_band_apply_plain(
                                                 x0, coef, True), None, 2 * nb + b * c * 16),
                "instance_norm_band_bwd_reduce": (
                    lambda: kin.instance_norm_band_bwd_reduce(x0, d0, coef, True, y0),
                    lambda: kin.instance_norm_band_bwd_reduce_plain(x0, d0, coef, True, y0),
                    None, 3 * nb + b * c * 24),
                "instance_norm_band_bwd_apply": (
                    lambda: kin.instance_norm_band_bwd_apply(x0, d0, coef, total, True, y0),
                    lambda: kin.instance_norm_band_bwd_apply_plain(x0, d0, coef, total, True,
                                                                   y0),
                    None, 4 * nb + b * c * 24)}
            for name, (kernel, plain, library, nbytes) in calls.items():
                bound_ms, bound_by = _bound(0.0, nbytes, dtype, peaks)
                rows.append({"name": name, "shape": [b, x0.shape[1], c], "image": list(shape),
                             "dtype": dname, "relu": True, "max_abs_err": errs[name],
                             "whole_map_gap": {"y": y_gap, "dx": dx_gap},
                             "ms": _time_ms(kernel), "plain_ms": _time_ms(plain),
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": _time_ms(library) if library else None})
            print(f"[spatial] {shape} {dname} bands {[e - a for a, e in bands_]} rows: "
                  + ", ".join(f"{r['name'][19:]} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                              f"bound {r['bound_ms']:.4f}) err {r['max_abs_err']:.2e}"
                              for r in rows[-4:]) + f"; whole map y {y_gap:.2e} dx {dx_gap:.2e}")
    return rows


def _sp_runs(mesh, out_dir: str) -> dict:
    """The spatial phase's loops and eval step (module docstring) on
    ``mesh`` (None: one device), under cuDNN's deterministic algorithms;
    each case's final losses, iterations, seconds and launches; the PNGs
    under ``out_dir/<case>`` (rank 0's on a mesh)."""
    import numpy as np
    import torch

    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply,
        truncated_resnet50_init,
    )
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.parallel.sharding import (
        make_spatial_eval_step,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev = mesh.device if mesh is not None else torch.device(DEVICE)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg3 = MultiPatchGANConfig(norm="instance")
    f2 = gram_attention_init(torch.Generator().manual_seed(0), 8, 4, POOL_S, device=dev)
    f3 = multiscale_test_init(torch.Generator().manual_seed(13), cfg3.patch_sizes, ndf=cfg3.ndf,
                              num_classes=cfg3.num_classes,
                              gram_matrix_dim=cfg3.gram_matrix_dim, norm="instance", device=dev)
    f1 = truncated_resnet50_init(torch.Generator().manual_seed(2), 8, 4, 256, device=dev)
    rng = np.random.RandomState(423)
    images = rng.randint(0, 256, (2, 256, 256, 3)).astype(np.uint8)
    style = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    batch = [{"image": images[:1], "label": np.array([1]), "n_valid": 1}]
    loop = dict(threshold=0.0, num_iterations=SP_ITERS, learning_rate=0.01, mesh=mesh,
                log_fn=lambda *a: None)
    cases = {
        "f2_texture": lambda d, h: pst.style_transfer_gram_attention(
            f2, batch, d, layers=8, truncate_layer=8, generator=torch.Generator().manual_seed(5),
            history=h, **loop),
        "content_style": lambda d, h: pst.content_style_transfer_gram_attention(
            f2, batch, style, d, layers=8, truncate_layer=8, style_layers="all",
            tv_weight=0.1, init="content", history=h, **loop),
        "f3_instance": lambda d, h: pst.style_transfer_patches(
            f3, batch, d, gram_matrix_dim=cfg3.gram_matrix_dim, norm="instance",
            generator=torch.Generator().manual_seed(6), history=h, **loop),
    }
    out = {}
    for case, run in cases.items():
        history = []
        kernels.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        run(os.path.join(out_dir, case), history)
        sync()
        seconds = time.perf_counter() - t0
        out[case] = {"iters": len(history[0]), "seconds": seconds,
                     "first": history[0][0].float().cpu().tolist(),
                     "final": history[0][-1].float().cpu().tolist(),
                     "image_iterations_per_s": len(history[0]) / seconds,
                     "launches": {k: v for k, v in kernels.launch_counts().items() if v}}
    step = make_spatial_eval_step(lambda m, x: combined_apply(m.moco, m.classifier, x, 8), mesh)
    staged = torch.from_numpy(images).to(dev)
    step(f1, staged)  # warm
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits = step(f1, staged)
    out["eval_step"] = {"logits": logits.float().cpu().tolist(),
                        "seconds": time.perf_counter() - t0,
                        "launches": {k: v for k, v in kernels.launch_counts().items() if v}}
    return out


def _sp_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """A spawned gloo rank of the spatial phase on card 0: ``_sp_runs`` on a
    1 x world mesh (rank 0 writing the PNGs), its results in
    ``out_dir/rank<r>.json``."""
    sys.path.insert(0, REPO)
    import torch

    from heuristique_style_transfer_code_tpu_torch.core.device import resolve_device
    from heuristique_style_transfer_code_tpu_torch.core.mesh import create_mesh
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        initialize_distributed,
        shutdown_distributed,
    )

    t0 = time.perf_counter()
    resolve_device(DEVICE)
    initialize_distributed(rank, world, init_method, backend="gloo")
    try:
        mesh = create_mesh(world, devices=[torch.device(DEVICE, 0)] * world, spatial=world)
        start_s = time.perf_counter() - t0
        runs = _sp_runs(mesh, os.path.join(out_dir, "ranks"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "spatial": mesh.spatial,
                       "staged_on_host": mesh.stage_on_host, "start_s": start_s,
                       "runs": runs}, f)
    finally:
        shutdown_distributed()


def _png_levels(root: str) -> dict:
    import numpy as np
    from PIL import Image

    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".png"):
                key = os.path.relpath(os.path.join(dirpath, name), root)
                if name.count("_") == 4:  # family 3's names end in a millisecond stamp
                    key = key.rsplit("_", 1)[0]
                with Image.open(os.path.join(dirpath, name)) as im:
                    out[key] = np.asarray(im, np.int16)
    return out


def phase_spatial(kernels, kin, peaks, tmp: str, timings: dict, smi: str) -> dict:
    """``--shard_spatial`` on the one card (module docstring): the banded
    K3/K3' entry points against their plain versions and the unbanded
    kernels; the loops and the eval step on SP_RANKS gloo ranks sharing
    card 0 (spawned while this process runs them on one device), held to
    one device, with each rank's launches and image-iterations/s."""
    import numpy as np

    from heuristique_style_transfer_code_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    out = {"power": smi, "kernel_rows": _sp_kernel_rows(kin, peaks)}
    sp_dir = os.path.join(tmp, "spatial")
    os.makedirs(sp_dir, exist_ok=True)
    spawn = {}

    def ranks_job():
        t0 = time.perf_counter()
        try:
            multihost.launch(SP_RANKS, None, [], target=_sp_rank, target_args=(sp_dir,),
                             rendezvous_dir=tmp, deadline_s=SP_TIMEOUT_S)
        except SystemExit as e:
            spawn["error"] = e
        spawn["seconds"] = time.perf_counter() - t0

    job = threading.Thread(target=ranks_job)
    job.start()
    try:
        one = _sp_runs(None, os.path.join(sp_dir, "one"))
    finally:
        job.join()
    _require("error" not in spawn, f"[spatial] a rank failed: {spawn}")
    out["spawn_and_runs_s"] = spawn["seconds"]
    ranks = []
    for r in range(SP_RANKS):
        with open(os.path.join(sp_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    pngs_one, pngs_ranks = _png_levels(os.path.join(sp_dir, "one")), \
        _png_levels(os.path.join(sp_dir, "ranks"))
    _require(sorted(pngs_one) == sorted(pngs_ranks) and len(pngs_one) == 3,
             f"[spatial] rank 0 wrote one device's PNGs: {sorted(pngs_one)} {sorted(pngs_ranks)}")
    out["cases"] = {}
    for case in ("f2_texture", "content_style", "f3_instance"):
        ref = one[case]
        gaps = []
        for rank in ranks:
            got = rank["runs"][case]
            _require(got["iters"] == ref["iters"] == SP_ITERS,
                     f"[spatial] {case}: iterations {got['iters']} against {ref['iters']}")
            gaps.append(max(abs(a - b) / abs(b) for a, b in zip(got["final"], ref["final"])))
        rate = ranks[0]["runs"][case]["image_iterations_per_s"]
        out["cases"][case] = {"loss_gap": max(gaps),
                              "first": ref["first"], "final": ref["final"],
                              "image_iterations_per_s": rate,
                              "one_device_image_iterations_per_s": ref["image_iterations_per_s"],
                              "launches_rank": [r["runs"][case]["launches"] for r in ranks],
                              "launches_one": ref["launches"]}
        print(f"[spatial] {case}: {SP_ITERS} iterations, final loss {ref['final']} (first "
              f"{ref['first']}), ranks' gap {max(gaps):.3g} relative; {rate:.2f} "
              f"image-iterations/s on the ranks against {ref['image_iterations_per_s']:.2f} "
              f"on one device; launches rank 0 {ranks[0]['runs'][case]['launches']}, one "
              f"device {ref['launches']}")
        _require(max(gaps) <= SP_TOL_LOSS, f"[spatial] {case}: losses {max(gaps):.3g} from "
                 f"one device's (tol {SP_TOL_LOSS})")
    # a gradient component near 0 may take the other sign from a band's
    # rounding, and Adam moves it by lr either way: at most 2 lr an
    # iteration, Adam's bound in uint8 steps (as the recycle phase's)
    bound = int(np.ceil(2 * 0.01 * SP_ITERS * 0.229 * 255))
    levels = {k: int(np.abs(pngs_ranks[k] - pngs_one[k]).max()) for k in pngs_one}
    within_one = {k: float((np.abs(pngs_ranks[k] - pngs_one[k]) <= 1).mean()) for k in pngs_one}
    out["png_levels"], out["png_within_one"] = levels, within_one
    _require(max(levels.values()) <= bound and min(within_one.values()) >= 0.99,
             f"[spatial] the PNGs within Adam's bound ({bound} steps), 99% within one: "
             f"{levels} {within_one}")
    want = np.asarray(one["eval_step"]["logits"])
    for rank in ranks:
        got = np.asarray(rank["runs"]["eval_step"]["logits"])
        gap = float(np.abs(got - want).max() / np.abs(want).max())
        _require(gap <= SP_TOL_LOGITS, f"[spatial] eval step logits {gap:.3g} from one "
                 f"device's (tol {SP_TOL_LOGITS})")
    out["eval_step"] = {"gap": gap, "seconds_rank": ranks[0]["runs"]["eval_step"]["seconds"],
                        "seconds_one": one["eval_step"]["seconds"]}
    # every banded entry point and the Grams on a band launched on each rank
    f3 = [r["runs"]["f3_instance"]["launches"] for r in ranks]
    for name in kin.BAND_KERNELS + ("gram_fwd", "gram_bwd"):
        _require(all(l.get(name, 0) > 0 for l in f3), f"[spatial] {name} launched on every "
                 f"rank of the family-3 loop: {f3}")
    for name in ("instance_norm_fwd", "instance_norm_bwd"):
        _require(all(l.get(name, 0) == 0 for l in f3), f"[spatial] the unbanded {name} "
                 f"never launched on a band: {f3}")
    out["launches"] = {name: sum(ranks[0]["runs"][c]["launches"].get(name, 0)
                                 for c in ("f2_texture", "content_style", "f3_instance",
                                           "eval_step"))
                       for name in [*kernels.launch_counts(), *kin.BAND_KERNELS]}
    print(f"[spatial] eval step logits {gap:.3g} from one device; PNG levels {levels}; "
          f"staged on host {ranks[0]['staged_on_host']}; spawn, start and runs "
          f"{spawn['seconds']:.1f} s ({smi})")
    timings["spatial_phase_s"] = time.perf_counter() - t_phase
    return out


def _only(phases: list, kernels, kg, kin, name: str, smi: str) -> int:
    """``--only a,b``: the named later phases alone (artifact, style_int8,
    native_decode, parallel_folds, data_parallel, serve_devices: the serve
    phase's ``devices`` piece), their results in
    ``chiprun_out/chip_smoke_only.json``; no result line."""
    import torch

    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import (
        load_gram_attention,
    )
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    known = ("artifact", "style_int8", "native_decode", "parallel_folds", "data_parallel",
             "serve_devices", "spatial")
    _require(set(phases) <= set(known), f"--only takes {known}: {phases}")
    out, timings = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for phase in phases:
            t0 = time.perf_counter()
            if phase == "artifact":
                out[phase] = phase_artifact(kernels, kg, kin, tmp, timings)
            elif phase == "style_int8":
                seeded = gram_attention_init(torch.Generator().manual_seed(0), 8, 4, POOL_S,
                                             device="cpu")
                ckpt = os.path.join(tmp, "family2.npz")
                save_pytree_npz(to_jax_tree(seeded), ckpt)
                model = load_gram_attention(ckpt, 8, 4, POOL_S, torch.device(DEVICE))
                out[phase] = phase_style_int8(kernels, model, seeded, timings)
            elif phase == "native_decode":
                out[phase] = phase_native_decode(tmp, timings)
            elif phase == "data_parallel":
                out[phase] = phase_data_parallel(kernels, tmp, timings, smi)
            elif phase == "spatial":
                out[phase] = phase_spatial(kernels, kin, _peaks(name), tmp, timings, smi)
            elif phase == "serve_devices":
                save_pytree_npz(to_jax_tree(gram_attention_init(
                    torch.Generator().manual_seed(0), 8, 4, POOL_S, device="cpu")),
                    os.path.join(tmp, "family2.npz"))
                out[phase] = _serve_devices(kernels, tmp, _serve_inputs(tmp)[1], smi)
            else:
                out[phase] = phase_parallel_folds(kernels, tmp, timings)
            print(f"[{phase}] {time.perf_counter() - t0:.2f} s")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_only.json"), "w") as f:
        json.dump({"device": name, "power": smi, "timings": timings, **out}, f, indent=1,
                  default=str)
    print(smi)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # internal: the recycle phase runs this script again as the proxy's parent
    parser.add_argument("--recycle-parent", metavar="SPEC", help=argparse.SUPPRESS)
    # some of the later phases alone, comma-separated (prints no result line)
    parser.add_argument("--only", help=argparse.SUPPRESS)
    cli = parser.parse_args()
    if cli.recycle_parent:
        sys.path.insert(0, REPO)
        return _recycle_parent(cli.recycle_parent)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: the port's package {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from heuristique_style_transfer_code_tpu_torch.core.device import resolve_device
    from heuristique_style_transfer_code_tpu_torch.ops import kernels
    from heuristique_style_transfer_code_tpu_torch.ops.kernels import gram as kg
    from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

    t_start = time.perf_counter()
    resolve_device("cuda")  # f32 stays f32: no TF32 in cuDNN or cuBLAS
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    peaks = _peaks(name)

    # whether the card's machine has tensorstore, the storage layer an orbax
    # checkpoint reader without jax would need (nothing is gated on it)
    import importlib.metadata
    import importlib.util

    has_ts = importlib.util.find_spec("tensorstore") is not None
    print(json.dumps({"tensorstore": has_ts,
                      "version": importlib.metadata.version("tensorstore") if has_ts else None}))

    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"[build] {', '.join(os.path.relpath(p, REPO) for p in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")

    if cli.only:
        return _only(cli.only.split(","), kernels, kg, kin, name, smi)

    timings = {}
    rows = phase_kernels(kg, peaks)
    rows["instance_norm_fwd"], in_checks = phase_in_kernels(kin, peaks)
    rows["instance_norm_bwd"] = phase_in_bwd_kernels(kin, peaks)
    rows["pooled_gram_bwd"] = phase_pooled_bwd_kernels(kg, peaks)
    rows["pooled_gram_fwd_y"] = phase_pooled_fwd_y(kg)
    in_bwd_checks = _forced_in_bwd_checks(kin)
    _gradient_guards(kg, kin)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model, seeded, cls_launches = phase_classification(kernels, tmp, timings)
        st_launches = phase_style_transfer(kernels, model, seeded, tmp, timings)
        fs_launches = phase_fast_style(kernels, tmp, timings)
        phase_conditional(kernels)
        phase_texture_serve(kernels, tmp)
        t0 = time.perf_counter()
        family1 = _family1(tmp)
        phase_family1_classification(kernels, family1, tmp, timings)
        phase_family1_inference(kernels, family1, tmp)
        phase_camera(kernels, family1, timings)
        phase_camera_video(family1, tmp, timings)
        timings["family1_and_camera_phases_s"] = time.perf_counter() - t0
        print(f"[family1+camera] {timings['family1_and_camera_phases_s']:.2f} s in all")
        t0 = time.perf_counter()
        family2 = _family2(tmp)
        family3 = {norm: _family3(tmp, norm) for norm in ("batch", "instance")}
        f3_results = {
            "batch": phase_family3_classification(kernels, family3["batch"], timings, tmp,
                                                  F3_BATCHES),
            "instance": phase_family3_classification(kernels, family3["instance"], timings,
                                                     tmp, F3_INSTANCE_BATCHES)}
        embeddings = phase_embeddings(kernels, family1, family2, family3["batch"], tmp)
        cameras = phase_family_cameras(kernels, family2, family3["batch"], timings)
        timings["family3_embeddings_cameras_phases_s"] = time.perf_counter() - t0
        print(f"[family3+embeddings+cameras] "
              f"{timings['family3_embeddings_cameras_phases_s']:.2f} s in all")
        t0 = time.perf_counter()
        f3_style = phase_family3_style_transfer(kernels, family3, timings, tmp)
        pth = phase_pth(family1, family2, family3, tmp)
        timings["family3_style_pth_phases_s"] = time.perf_counter() - t0
        print(f"[family3_style_transfer+pth] {timings['family3_style_pth_phases_s']:.2f} s in all")
        t0 = time.perf_counter()
        gradcam = phase_gradcam(kernels, family1, tmp, timings)
        content_style = phase_content_style(kernels, model, seeded, tmp, timings)
        cs_serve = phase_content_style_serve(kernels, tmp)
        timings["gradcam_content_style_phases_s"] = time.perf_counter() - t0
        print(f"[gradcam+content_style+serve] {timings['gradcam_content_style_phases_s']:.2f} s "
              f"in all")
        t0 = time.perf_counter()
        fst = phase_fast_style_train(kernels, model, seeded, tmp, timings)
        timings["fast_style_train_phase_s"] = time.perf_counter() - t0
        print(f"[fast_style_train] {timings['fast_style_train_phase_s']:.2f} s in all")
        t0 = time.perf_counter()
        f2t = phase_family2_train(kernels, tmp, timings)
        timings["family2_train_phase_s"] = time.perf_counter() - t0
        print(f"[family2_train] {timings['family2_train_phase_s']:.2f} s in all")
        t0 = time.perf_counter()
        f1t = phase_family1_train(kernels, tmp, timings)
        timings["family1_train_phase_s"] = time.perf_counter() - t0
        print(f"[family1_train] {timings['family1_train_phase_s']:.2f} s in all")
        t0 = time.perf_counter()
        f3t = phase_family3_train(kernels, tmp, timings)
        timings["family3_train_phase_s"] = time.perf_counter() - t0
        print(f"[family3_train] {timings['family3_train_phase_s']:.2f} s in all")
        t0 = time.perf_counter()
        remat = phase_remat(kernels, tmp, timings)
        f3_serve = phase_family3_serve(kernels, family3, tmp, timings)
        dispatch = phase_dispatch(kernels, family1, tmp, timings)
        accum = phase_grad_accum(kernels, tmp, timings)
        profile_debug = phase_profile_debug(kernels, tmp, timings)
        timings["pr17_phases_s"] = time.perf_counter() - t0
        print(f"[remat+family3_serve+dispatch+grad_accum+profile_debug] "
              f"{timings['pr17_phases_s']:.2f} s in all")
        t0 = time.perf_counter()
        ema_mix = phase_ema_mix(kernels, tmp, timings)
        auto_batch = phase_auto_batch(kernels, tmp, timings)
        int8 = phase_int8(kernels, family1, family2, tmp, timings)
        timings["ema_mix_auto_batch_int8_phases_s"] = time.perf_counter() - t0
        print(f"[ema_mix+auto_batch+int8] {timings['ema_mix_auto_batch_int8_phases_s']:.2f} s "
              f"in all")
        t0 = time.perf_counter()
        serving = phase_serve(kernels, tmp, timings, smi)
        timings["serve_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        recycle = phase_recycle(kernels, tmp, timings)
        timings["recycle_phase_s"] = time.perf_counter() - t0
        print(f"[serve+recycle] {timings['serve_phase_s']:.2f} + "
              f"{timings['recycle_phase_s']:.2f} s")
        artifact = phase_artifact(kernels, kg, kin, tmp, timings, serving, recycle)
        print(f"[artifact] {timings['artifact_phase_s']:.2f} s in all")
        style_int8 = phase_style_int8(kernels, model, seeded, timings)
        native_decode = phase_native_decode(tmp, timings)
        parallel = phase_parallel_folds(kernels, tmp, timings)
        print(f"[style_int8+native_decode+parallel_folds] {timings['style_int8_phase_s']:.2f} + "
              f"{timings['native_decode_phase_s']:.2f} + "
              f"{timings['parallel_folds_phase_s']:.2f} s")
        data_parallel = phase_data_parallel(kernels, tmp, timings, smi)
        spatial = phase_spatial(kernels, kin, peaks, tmp, timings, smi)
        print(f"[data_parallel+spatial] {timings['data_parallel_phase_s']:.2f} + "
              f"{timings['spatial_phase_s']:.2f} s")
    cs_launches = {k: content_style["launches"][k] + cs_serve["launches"][k]
                   for k in ("gram_fwd", "gram_bwd")}
    fst_launches = fst["launches"]
    launches = {"pooled_gram_fwd": cls_launches["pooled_gram_fwd"]
                + f2t["launches"]["pooled_gram_fwd"] + ema_mix["launches"]["pooled_gram_fwd"]
                + int8["launches"]["pooled_gram_fwd"] + serving["launches"]["pooled_gram_fwd"],
                "pooled_gram_bwd": f2t["launches"]["pooled_gram_bwd"]
                + ema_mix["launches"]["pooled_gram_bwd"],
                "gram_fwd": st_launches["gram_fwd"] + cs_launches["gram_fwd"]
                + fst_launches["gram_fwd"] + f3_serve["launches"]["gram_fwd"]
                + serving["launches"]["gram_fwd"],
                "gram_bwd": st_launches["gram_bwd"] + cs_launches["gram_bwd"]
                + fst_launches["gram_bwd"] + f3_serve["launches"]["gram_bwd"]
                + serving["launches"]["gram_bwd"],
                "instance_norm_fwd": fs_launches["instance_norm_fwd"]
                + fst_launches["instance_norm_fwd"] + f3t["launches"]["instance_norm_fwd"]
                + remat["launches"]["instance_norm_fwd"]
                + f3_serve["launches"]["instance_norm_fwd"]
                + ema_mix["launches"]["instance_norm_fwd"]
                + serving["launches"]["instance_norm_fwd"],
                "instance_norm_bwd": f3_style["instance_float32"]["launches"]["instance_norm_bwd"]
                + fst_launches["instance_norm_bwd"] + f3t["launches"]["instance_norm_bwd"]
                + remat["launches"]["instance_norm_bwd"]
                + f3_serve["launches"]["instance_norm_bwd"]
                + ema_mix["launches"]["instance_norm_bwd"]}
    launches.update({k: 0 for k in kin.BAND_KERNELS})
    for part in (artifact, style_int8, parallel, data_parallel, spatial):
        for k, v in part["launches"].items():
            launches[k] += v
    idle = [k for k in launches if launches[k] == 0]
    _require(not idle, f"every kernel launched on the main path: {idle}")

    records = []
    replaces = {"gram_fwd": f"{PALLAS}:60", "gram_bwd": f"{PALLAS}:60",
                "pooled_gram_fwd": f"{PALLAS}:100", "pooled_gram_bwd": f"{PALLAS}:100",
                "instance_norm_fwd": f"{PALLAS_IN}:192",
                "instance_norm_bwd": f"{PALLAS_IN}:192",
                **{k: f"{PALLAS_IN}:192" for k in kin.BAND_KERNELS}}
    sources = {"gram_fwd": SOURCE["gram"], "gram_bwd": SOURCE["gram"],
               "pooled_gram_fwd": SOURCE["gram"], "pooled_gram_bwd": SOURCE["gram"],
               "instance_norm_fwd": SOURCE["instance_norm"],
               "instance_norm_bwd": SOURCE["instance_norm"],
               **{k: SOURCE["instance_norm"] for k in kin.BAND_KERNELS}}
    rows.update({k: [r for r in spatial["kernel_rows"] if r["name"] == k]
                 for k in kin.BAND_KERNELS})
    for kname in launches:
        # the net's first norm (in1, with its ReLU) stands for K3's record, the
        # style loop's first (b1, 112², ReLU) for its backward's; the banded
        # entry points' by rank 0's band of the family-3 loop's first map
        main_row = next(r for r in rows[kname]
                        if tuple(r["shape"]) == MAIN_SHAPE[kname] and r["dtype"] == "float32"
                        and r.get("relu", True))
        records.append({
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname], "launches": launches[kname],
            "shape": list(MAIN_SHAPE[kname]), "dtype": "float32",
            **{k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        })
    timings["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "power": smi, "rows": rows, "timings": timings,
                   "instance_norm_checks": in_checks, "instance_norm_bwd_checks": in_bwd_checks,
                   "records": records, "family3": f3_results,
                   "embeddings": embeddings, "cameras": cameras, "family3_style": f3_style,
                   "pth": pth, "gradcam": gradcam, "content_style": content_style,
                   "content_style_serve": cs_serve, "fast_style_train": fst,
                   "family2_train": f2t, "family1_train": f1t, "family3_train": f3t,
                   "remat": remat, "family3_serve": f3_serve, "dispatch": dispatch,
                   "grad_accum": accum, "profile_debug": profile_debug, "ema_mix": ema_mix,
                   "auto_batch": auto_batch, "int8": int8, "serve": serving,
                   "recycle": recycle, "artifact": artifact, "style_int8": style_int8,
                   "native_decode": native_decode, "parallel_folds": parallel,
                   "data_parallel": data_parallel, "spatial": spatial}, f, indent=1,
                  default=str)
    print(f"[chip_smoke] {timings['total_s']:.1f} s in all, the kernels' build included")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
