#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lednet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the flagship LED-Net (``configs/LED_Net/lednet_80k_cityscapes-1024x1024.py``:
LEDNet c=32, ppm_channels=128, LEDHead with 19 classes) through the port's
own entry points, ``init_model`` -> ``inference_model``, at full width on
1024x1024 images, with seeded random weights and non-trivial BatchNorm
running stats.  It imports nothing of JAX or of the JAX package.  Phases, each
printing one flushed line with its seconds:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the CUDA kernels from ``lednet_tpu_torch/csrc`` (one ``nvcc -c``
   per source, all started together, then one link);
3. kernels: one forward records every kernel call of the main path, and
   a device trace (``torch.profiler``) of it counts each kernel's CUDA
   launches per forward; each call is re-run through the kernel and through
   its plain PyTorch version on the same inputs and held to
   max|kernel - plain| <= TOL * max|plain| (normalization: bit-exact);
3b. pyramid: kernel E (``sesp_pyramid``), which no model calls, held to
   its plain version like phase 3, with the v2 stage and without, at three
   sets: the flagship set, each distinct pyramid shape of the SESP calls
   recorded in phase 3 (n, H, W, rates, stride; their dw1/dw2 and a seeded
   random reduced map); the val set, the same at Runner.val's B=8 and W
   doubled (8 x 1024 x 2048 frames); ragged shapes (RAGGED_PYRAMID: W % 4
   != 0, which takes the cp.async path, maps smaller than one tile, k = 1,
   2, 3), each line naming TMA or cp.async and the tile; a device trace of
   these checks must count one launch of E's device functions
   (``DEVICE_FUNCTIONS``, which the later "E never launches" readings use)
   per check;
3c. ragged: kernels B and C called directly at shapes the main path (which
   pads to /32) never gives them: batch 2, sizes that are not multiples of
   the tiles (odd and even), maps smaller than one tile, bf16 and float32
   stem inputs, the 16-channel width; held like phase 3;
4. model: launch counts set to 0, ``inference_model`` on 4 seeded
   1024x1024 BGR uint8 images through the kernels under a device trace,
   counts read.  ``inference_model`` runs one eager warm-up forward, captures
   a CUDA graph and replays it 4 times: every kernel of the main path, A-D,
   must count launches in its wrapper (warm-up and capture; E is on no path
   and is not required), and the trace must show each kernel's launches of
   one forward (phase 3) 5 times over, which the replays run.  Then the
   same images with ``impl='plain'`` (module forms), the
   same images again under torch's default flags (cuDNN convs in TF32)
   against those float32 module forms, and a 256x256 image against the
   model copied to the CPU;
5. timing: CUDA-event time of the kernel-path forward (preprocess +
   predict, bs=1, 5 warm-up + 50 timed), the plain path's, and each kernel's
   and plain version's time per launch at the main path's inputs (E's at
   phase 3b's flagship set); kernel D's time is printed per call site, and
   B's, C's and D's beside their times before their redesigns.  Kernel E
   at its flagship and val sets, per shape and summed: device time
   (``torch.profiler``) beside EARLIER_PYRAMID_MS (before its redesign) and
   its share of the bound, CUDA-event time, bound, plain version, and
   cuDNN's nearest composition (``cudnn_pyramid``: three calls, timed as a
   yardstick only and never called by the port, so ``library_ms`` stays
   null).
   Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
   operations over the peak of the units it runs them on: TF32 tensor cores
   (495 TFLOP/s, three TF32 products per float32 product, two for a bf16
   operand) for B and C, the float32 pipes (67 TFLOP/s) for the others;
6. train: ``make_train_step`` (module forms, BatchNorm on batch statistics,
   the config's two OHEM losses, SGD + poly lr) on a fresh seeded flagship
   model, at the config's batch of 6 seeded 1024x1024 BGR uint8 crops with
   about 2% of labels at 255: one warm-up step and 5 timed steps (CUDA
   events; loss, acc_seg and grad_norm of each must be finite), peak memory,
   3 more steps under torch's default flags (cuDNN TF32); then, for 4
   seeds, one step on the card against the same step of the port on the
   CPU (flagship widths, 2 images at 256x256, same seeded weights and
   batch, float32, TF32 off), with the config's OHEM losses and with
   ``CrossEntropyLoss`` in their place, held to the loss within 1e-5,
   every weight within atol 1e-4 / rtol 5e-3 and the BatchNorm running
   stats within atol 1e-5 (var also rtol 1e-4) with the card's convs in
   PyTorch's own CUDA kernels (cuDNN off), and to the loss and stat bounds
   with cuDNN (its weights printed beside them): cuDNN's float32 weight
   gradients sum in an order about 600 times less exact than PyTorch's
   own, and move the weights past the bound at some seeds
   (``tools/torch_port_train_gap.py``, ``PERF.md`` section 6);
7. eval graph: ``make_eval_step`` on the phase-3 model, bs=1, 1024x1024:
   the replayed CUDA graph against the eager kernel path (max abs error <=
   TOL_KERNEL x max|logit|, argmax agreement 1.0); then one train step
   changes the weights, and the step must capture again and match the eager
   forward with the new weights under the same bound; ``inference_model``
   against the eager path likewise; then the forward latency of the replay
   against the eager kernel path (CUDA events, 5 warm-up + 50 timed), the
   same one frame at a time (host clock, synchronized after each call), the
   host time of the step's check of the weights, and the number of graphs
   captured.

8. entry points: a Cityscapes-layout tree of 12 train and 4 val seeded
   2048x1024 PNG frames in two cities, written by the port's encoder into
   a temporary directory; kernels A-D held to their plain versions at the
   val shape 8 x 1024 x 2048 (as phase 3, with a device trace of their
   launches); ``tools/torch_port_train.py`` on the flagship config
   (batch 6 of 1024x1024 crops, 4 loader threads, 20 steps, val
   every 10, checkpoints every 10, a log line every 5): finite losses, two
   val results, ``iter_10.pth``, ``iter_20.pth`` and ``last_checkpoint``;
   ``--resume`` to 30, which must start at step 20 with the schedule's lr
   there; ``tools/torch_port_test.py`` on ``iter_20.pth``, whose metrics
   must equal the val at step 20 exactly; ``inference_model`` on a PNG path
   and on a 1280x720 array with cv2 and PIL blocked; then the card's own
   numbers from a ``Runner`` in this process: train iteration time and the
   share of it spent waiting on the loader (steps 6-20), the device idle
   share over steps 6-15 (``torch.profiler``), the eval step's time at 8 x
   1024 x 2048 (CUDA events) and ``Runner.val``'s wall time, peak memory of
   train and of train + val; launch counts set to 0 before that train +
   val run and read after (A-D must launch, in val).

9. branch: LED-Net on Apple Branch (``configs/LED_Net/lednet_80k_branch-
   512x1024.py``, 2 classes) on a tree of 8 train and 4 val seeded
   1920x1080 JPEG frames and one 1080x1440 portrait frame stored on its
   side with EXIF orientation 6 (in both lists), written by the port's
   JPEG encoder into a temporary directory: JPEG decode time per frame (the
   portrait must read upright) and the train pipeline's host time per
   sample by transform; kernels A-D held to their plain versions at both
   val shapes (8 x 512 x 1024, 8 x 768 x 512) and at all 12 test-time view
   shapes (1 x 640 x 1024 to 1 x 1920 x 3456), each with a device trace of
   one forward; ``tools/torch_port_train.py`` on the branch config (its
   batch of 2, 2 loader threads, 20 steps, val and checkpoints every 10):
   finite losses, two val results; ``tools/torch_port_test.py`` on
   ``iter_20.pth`` equal to the val at step 20, and with ``--tta``, finite
   metrics; then a ``Runner`` in this process: train iteration time and
   loader wait (steps 6-20), ``Runner.test`` without and with TTA under a
   device trace (launch counts set to 0 before, read after: A-D must
   launch, on the device once per forward the graphs ran), both again
   timed (no graph may be captured again), one frame's 12 views through
   ``Runner.predict_tta`` replayed against the eager kernel path (mean
   probabilities within TOL_KERNEL, argmax agreement 1, the prediction
   equal) and the time of each, graphs captured and peak memory.

10. zoo: DDRNet-23-slim and BiSeNetV1 R-18 (``configs/ddrnet/``,
   ``configs/bisenetv1/``, unchanged) at full width, seeded weights and
   non-trivial BatchNorm stats: kernel A, their only kernel, at float32
   output (these configs set no ``out_dtype``) against its plain version,
   exact, at 1 x 1024 x 1024 and at the val shape 8 x 1024 x 2048; launch
   counts set to 0, ``inference_model`` on 2 seeded 1024x1024 images
   through the kernels under a device trace, counts read (A must launch
   once per forward on the device, B-E never); the kernel path and
   ``inference_model`` under torch's default TF32 flags against the
   float32 module forms (TOL_MODEL, argmax >= 99.9%); ``make_eval_step``
   replayed against the eager kernel path (TOL_KERNEL, argmax 1) and both
   timed (CUDA events, ZOO_TIMED calls after 1); kernel A's time at
   float32 output; DDRNet-23 (c=64) once, eager and replayed; each
   config's train step at its batch (6, 4) at 1024x1024, ZOO_TRAIN_STEPS
   timed steps after a warm-up, peak memory; one step at 2
   x 256x256 on the card (cuDNN off) against the CPU's within phase 6's
   bounds in float64, and in float32 with the step's discrete decisions
   (OHEM's kept pixels, ReLU signs, max pool choices) pinned to the CPU
   float64 step's, its loss, weights and BatchNorm stats each within the
   larger of phase 6's bound and 3x the CPU float32 step's own distance
   from float64 on the same inputs and decisions, on all threads or on one
   (``float32_bounds``; the
   elements each float32 step decides otherwise, unpinned, counted),
   BiSeNetV1 with dropout 0 in every head for this comparison only (two
   RNG streams cannot drop the same units); DDRNet-23-slim through
   ``tools/torch_port_train.py`` (``ZOO_ITERS`` steps, one val) on a tree of 6 + 2
   2048x1024 frames, its iteration time and loader wait from the log, and
   ``tools/torch_port_test.py`` on ``iter_20.pth`` equal to that val (in
   every phase each CLI's ``main`` runs in this process, under torch's
   default TF32 flags, ``call_cli``: a process of its own costs 20-25 s
   before its first step on the card's host);
11. PIDNet and STDC: phase 10's checks of PIDNet-S and STDC1
   (``configs/pidnet/``, ``configs/stdc/``, unchanged) at full width and bs
   1 at 1024x1024 (A exact at float32 output, A once per forward and B-E
   never, kernel path and TF32 defaults against module forms, replay
   against eager, both timed); PIDNet-M, PIDNet-L and STDC2 one replayed
   forward each against eager; train steps at the configs' batches
   (PIDNet-S 6 x 1024x1024 with edge maps from ``GenerateEdge``, STDC1 12
   x 1024x1024, its loader's crop, where its preprocessor's size is
   512x1024); the card's step against the CPU's at 2 x 256x256 with
   dropout 0 (float64; float32 with PIDHead's boundary gate pinned
   too); PIDNet-S through the train and test CLIs on phase 10's tree;
12. BiSeNetV2 and HRNet: ``init_model`` on the card of their 4 + 10
   configs (``BISE_HRNET_CONFIGS``); phase 10's checks of BiSeNetV2 (its
   ``-ohem-`` config: an ``OHEMPixelSampler`` on all five heads) and
   HRNet-W18 (``configs/bisenetv2/``, ``configs/hrnet/``, unchanged) at
   full width and bs 1 at 1024x1024; HRNet-W18-Small and HRNet-W48 one
   replayed forward each against eager; train steps at the configs'
   batches (BiSeNetV2 4 x 1024x1024, HRNet-W18 2 x 512x1024), the card's
   step against the CPU's at 2 x 256x256 (float64; float32 with each
   sampler's keep mask pinned too); the ``-amp-`` config's bfloat16 step
   (``bf16_step``: bs 4 at 1024x1024, dropout 0, finite losses, float32
   master weights and gradients, its first loss within 2^-8 of the
   float32 step's, relatively, both timed, peak memory); the ``-amp-`` config
   (the Runner's ``bf16`` path) and HRNet-W18 through the train and test
   CLIs on phase 10's tree.
13. SegNeXt: ``init_model`` on the card of its 4 configs (``configs/segnext/``,
   unchanged: MSCAN-T/S/B/L, LightHamHead, 150 ADE20K classes) with their
   parameter counts; phase 10's checks of SegNeXt-T at full width and bs 1
   at 1024x1024 (A exact at float32 output, A once per forward and B-E
   never, kernel path and TF32 defaults against module forms, replay
   against eager, both timed); SegNeXt-S, B and L one replayed forward each
   against eager; the train step of T at its config's batch (16 x
   512x512); the card's step against the CPU's at 2 x 256x256 past the
   ``LinearLR`` warm-up (at state step ``SEGNEXT_START``, where the update
   is measurable; at step 0 the lr is 6e-11), with dropout and
   ``drop_path_rate`` 0 (float64; float32 with ReLU signs pinned); T through
   the train and test CLIs on a fabricated ADE20K tree (``ADE_TREE_*``
   frames of two aspects, so val runs two padded shapes).
14. slide: ``init_model`` on the card of the 13 configs that set
   ``test_cfg.mode='slide'`` (``SLIDE_CONFIGS``: UNet-S5-D16 on DRIVE,
   HRNet-W18/W18-Small/W48 on Pascal Context and Context-59, unchanged)
   with their parameter counts; phase 10's checks of UNet-S5-D16 at full
   width through ``inference_model`` on 2 seeded 584x565 frames (padded to
   608x576: 196 crops of 64x64 in one batched forward), in slide mode: A
   exact at float32 output, A once per slide forward (on the whole padded
   image, before the crops) and B-E never on the device, the kernel path
   and TF32 defaults against the module forms, the replayed graph (crop
   gather, batched forward and every accumulate) against eager, both timed
   with their peak memory; its train step at the config's batch (4 x
   64x64) and the card's step against the CPU's at 4 x 64x64 (float64;
   float32 with ReLU signs and max pool choices pinned); HRNet-W18 on
   Pascal Context-59: one replayed slide forward on a 500x500 frame (2 x 2
   crops of 480) against eager, its train step at 4 x 480x480, and
   ``inference_model`` on a 500x375 photo raising as the JAX package does
   (resized to 390x520, padded to 416 rows < the 480 crop); UNet through
   the train and test CLIs on a fabricated DRIVE tree (``DRIVE_TREE_*``
   frames of 584x565), the test CLI equal to the last step's val, then once
   more with ``--tta`` (the ``tta_pipeline`` of
   ``configs/_base_/datasets/drive.py``, passed as a cfg option: the UNet
   config has none), mDice printed; HRNet-W18 on
   Pascal Context-59 through the train and test CLIs on a fabricated
   Pascal Context tree (``PASCAL_TREE_*`` JPEGs of 500x375 and 375x500; no
   ``--tta``: its 0.5 view is smaller than the crop and raises, as in the
   JAX package).
15. datasets: ``init_model`` on the card of the 24 configs that the VOC +
   SBD aug, COCO-Stuff 164k, iSAID, LoveDA, Potsdam and Vaihingen datasets
   unblock (``DATASET_CONFIGS``: HRNet-W18/W18-Small/W48 on the first
   five, BiSeNetV1 R-18/R-50/R-101 on COCO-Stuff, unchanged) with their
   parameter counts; phase 10's checks of BiSeNetV1 R-50 (a ResNet-50
   context path, 171 classes) at full width and bs 1 at 1024x1024 (A
   exact at float32 output, A once per forward and B-E never, the kernel
   path and TF32 defaults against module forms, replay against eager,
   both timed), R-101 one replayed forward against eager, R-50's train
   step at the config's batch (4 x 512x512) and the card's step against
   the CPU's at 2 x 256x256 (float64; float32 with ReLU signs and max
   pool choices pinned); then, on fabricated trees (``VOC_TREE_*`` PNGs
   of 500x375 and 375x500 in the VOC2012 + SBD layout, ``COCO_TREE_*``
   640x480 JPEGs, ``ISAID_TREE_*`` 896x896 PNG tiles), HRNet-W18 on VOC
   aug (a ``ConcatDataset`` of the train and aug lists, ``Pad`` to
   512x512; a 21-class head under the 2-class ``PascalVOCDataset`` meta,
   as in the JAX package) and BiSeNetV1 R-50 on COCO-Stuff through the
   train and test CLIs, the test CLI equal to the last step's val, and
   HRNet-W18-Small on iSAID (bs 4 of 896x896 crops) through the train
   CLI with its val, each with its iteration time and loader wait.
16. realtime: phase 10's checks of the real-time Cityscapes zoo's next
   five families (``REALTIME``: ICNet R-18 with ``ICNeck`` and two
   auxiliary heads, Fast-SCNN, ERFNet, CGNet, LR-ASPP MobileNetV3-L;
   ``configs/{icnet,fastscnn,erfnet,cgnet,mobilenet_v3}/``, unchanged) at
   full width and bs 1 on the Cityscapes test frame, 1024x2048 (A exact at
   float32 output, A once per forward and B-E never, the kernel path and
   TF32 defaults against module forms, replay against eager, both timed
   as phase 10), the replayed graph and the eager kernel path on
   a CPU_FRAME_HW frame against the model copied to the CPU; each train
   step at the config's batch of its loader's 1024x1024 crops (its own
   ``crop_size`` reaches only the preprocessor); the card's step against
   the CPU's at REALTIME_CHECK, 4 x 128x128 (float64; float32 with ReLU
   signs and max pool choices pinned; ERFNet's backbone dropout 0 too);
   ICNet (the neck and
   both auxiliary heads) and CGNet (class-weighted CE, Adam) through the
   train and test CLIs on phase 10's tree, the test CLI equal to the
   last step's val.
17. sctnet rtformer psp: phase 16's checks of SCTNet-B (``SCTHead``, OHEM),
   RTFormer-Base (external and cross-resolution attention, OHEM on its
   decode and auxiliary heads), PSPNet R50-D8 (``PSPHead``) and
   DeepLabV3+ R50-D8 (``DepthwiseSeparableASPPHead`` with its c1 skip)
   (``SCT_RTF_PSP``; ``configs/{sctnet,rtformer,pspnet,deeplabv3plus}/``,
   unchanged) at full width and bs 1 on the 1024x2048 Cityscapes test
   frame, RTFormer-Slim one replayed forward against eager; each train
   step at its config's batch and its loader's 1024x1024 crops; the
   card's step against the CPU's at REALTIME_CHECK, 4 x 128x128, and the
   R50-D8 pair's at R50_D8_CHECK, 4 x 128x128 (SCTNet's drop path and the
   heads' dropout 0); DSNet-S (``DSNET_CONFIG``) as the module the JAX
   package runs (``dsnet_module``: ``init_model`` raises on its config;
   its eval forward on a normalized 1024x2048 frame, its three outputs
   against the module copied to the CPU at CPU_FRAME_HW, no kernel
   launched, eager time); RTFormer-Base (its own schedule, batch 6) and
   DeepLabV3+ through the train and test CLIs on phase 10's tree, the
   test CLI equal to the last step's val.
18. cascade transformers: phase 16's checks of the cascade segmentor
   (``CascadeEncoderDecoder``: OCRNet HR18, an FCN stage then ``OCRHead``;
   PointRend R50, an FCN stage then ``PointHead``, whose subdivision,
   its sort and ``scatter`` included, runs inside the replayed graph) and
   SegFormer MiT-B0 (``CASCADE_MIT``; ``configs/{ocrnet,point_rend,
   segformer}/``, unchanged) at full width and bs 1 on the 1024x2048
   Cityscapes test frame, and of UPerNet Swin-T (``SWIN``,
   ``configs/swin/``, unchanged) on an ADE20K test frame of 512x683 (the
   test resize of a 640x480 photo), each against its CPU copy at
   CPU_FRAME_HW (Swin at SWIN_CPU_HW, a width of 3 mod 4); each train
   step at its config's batch of its loader's crops; the card's step
   against the CPU's at PHASE18_CHECK, 4 x 128x128 (dropout in every
   stage and drop path 0; SegFormer past its warm-up; in float32
   PointHead's training points pinned with the other decisions; both
   devices draw the same candidates from the head's own CPU generator);
   OCRNet through the train and test CLIs on phase 10's tree (its val is
   the cascade's last stage through ``Runner.val``) and Swin-T on phase
   13's ADE20K tree (val frames resized to 512x683 and 768x512), the test
   CLI equal to the last step's val.
19. knet mask2former: phase 16's checks of the first mask-classification
   heads, K-Net s3 R50-D8 (``IterativeDecodeHead``: an FCN kernel-generate
   head and three kernel-update stages) and Mask2Former R50
   (``Mask2FormerHead``: an FPN pixel decoder, masked-attention queries;
   its ``(class, mask)`` logits reach ``predict_by_feat`` inside the
   replayed graph), ``KNET_M2F`` (``configs/{knet,mask2former}/``,
   unchanged), at full width and bs 1 on the 1024x2048 Cityscapes test
   frame, each against its CPU copy at CPU_FRAME_HW; each train step at
   its config's batch of its loader's crops; the card's step against the
   CPU's at PHASE19_CHECK, 4 x 128x128 (dropout 0; in float32 K-Net's hard
   masks, Mask2Former's attention masks, its Hungarian assignment on the
   host and its loss's uncertain points pinned with the other decisions;
   both devices draw the same points from the head's own CPU generator);
   one Mask2Former forward with the deformable pixel decoder
   (``MSDEFORM``, through the config options), replayed and eager and
   against its CPU copy; both through the train and test CLIs on phase
   10's tree, each test CLI equal to its last step's val.
20. san: SAN ViT-B16 (``MultimodalEncoderDecoder``: CLIP's ViT on the
   half-size image, the CLIP text tower on 19 'vild' templates x 19
   classes, ``SideAdapterCLIPHead``; ``configs/san/``, unchanged, run with
   ``SAN_OPTIONS``: ``out_origin=True`` through the config options) as
   phase 16 checks its models, at full width and bs 1 on the 1024x2048
   Cityscapes test frame (A exact at float32 output, A once per forward
   and B-E never, the kernel path and TF32 defaults against the module
   forms, replay against eager, both timed), with the text tower's share
   of the replayed forward; the eval step at CPU_FRAME_HW against its CPU
   copy with one template (``SAN_SIMPLE``); its train step at the config's
   batch of its loader's 1024x1024 crops with the host time of each
   Hungarian matching; the card's step against the CPU's at
   PHASE20_CHECK, 4 x 128x128, one template (float64; float32 with the
   ReLU signs, the assignment and the loss's points pinned); through the
   train and test CLIs on phase 10's tree (``--cfg-options
   model.image_encoder.out_origin=True``), the test CLI equal to the
   last step's val; the config as shipped raising ``ValueError``.
21. vit fpn: the ViT segmenters and the semantic FPN, eight
   ``configs/_base_/models`` files (unchanged) composed with their
   datasets, schedules and the runtime into the phase's temporary
   directory (``VIT_FPN``, ``compose_base``), as phase 16 checks its
   models at full width and bs 1: SETR naive, PUP and MLA (ViT-L), FPN R50
   and PointRend over it on the 1024x2048 Cityscapes test frame,
   Segmenter (slide), DPT and the MLN UPerNet (ViT-B) on a 512x683 ADE20K
   frame; each against its CPU copy (Segmenter at 512x683; PointRend's
   subdivision points pinned to the CPU's where a near-tie swaps one);
   each train step at the composed config's batch and crop with its drop
   rates active; the card's step against the CPU's, the rates 0
   (``without_dropout``), for SETR-MLA (SETR_MLA_CHECK), Segmenter and DPT
   (VIT_B_CHECK) and PointRend-FPN (PHASE21_CHECK); SETR-MLA (val one
   frame a chunk), PointRend-FPN and Segmenter (slide val, phase 13's
   ADE20K tree) through the train and test CLIs, each test CLI equal to
   the last step's val.
22. context heads: the ten R50-D8 context-head ``configs/_base_/models``
   files (ANN, APC, CC, DA, DM, EMA, Enc, GC, ISA, PSA; unchanged),
   composed with Cityscapes, the 80k schedule and the runtime
   (``CONTEXT_HEADS``, ``compose_base``), as phase 16 checks its models
   at full width and bs 1 on the 1024x2048 Cityscapes test frame, DANet's
   and CCNet's gammas seeded nonzero; each against its CPU copy at
   CPU_FRAME_HW; each train step at the composed config's batch and crop;
   the card's step against the CPU's at CONTEXT_CHECK (4 x 64x64) for
   EMANet, EncNet and DANet; EMANet through the train and test CLIs, the
   test CLI equal to the last step's val; NLHead and DNLHead, whose files
   raise, built without ``mode`` on a seeded NL_FEATURE map against their
   CPU copies.

It prints the card line and a ``{"kernels": [...]}`` line (``launches``:
the wrappers' count in phase 4; ``device_launches``: the CUDA launches the
device trace saw there; ``entry_point_launches`` and
``entry_point_device_launches``: the same of phase 8's train + val run;
``branch_launches``, ``branch_device_launches``: the same of phase 9's
test + TTA run; ``branch_max_abs_err``: the kernel's largest error against
its plain version over phase 9's shapes; ``zoo_launches``,
``zoo_device_launches``: the same of phase 10's ``inference_model`` runs,
``zoo_max_abs_err``: A's at float32 output; ``pid_stdc_launches``,
``pid_stdc_device_launches``, ``pid_stdc_max_abs_err``: the same of phase
11; ``bise_hrnet_launches``, ``bise_hrnet_device_launches``,
``bise_hrnet_max_abs_err``: the same of phase 12; ``segnext_launches``,
``segnext_device_launches``, ``segnext_max_abs_err``: the same of phase
13; ``slide_launches``, ``slide_device_launches``, ``slide_max_abs_err``:
the same of phase 14; ``datasets_launches``, ``datasets_device_launches``,
``datasets_max_abs_err``: the same of phase 15; ``realtime_launches``,
``realtime_device_launches``, ``realtime_max_abs_err``: the same of phase
16; ``sct_rtf_psp_launches``, ``sct_rtf_psp_device_launches``,
``sct_rtf_psp_max_abs_err``: the same of phase 17;
``cascade_transformers_launches``, ``cascade_transformers_device_launches``,
``cascade_transformers_max_abs_err``: the same of phase 18;
``knet_m2f_launches``, ``knet_m2f_device_launches``,
``knet_m2f_max_abs_err``: the same of phase 19; ``san_launches``,
``san_device_launches``, ``san_max_abs_err``: the same of phase 20;
``vit_fpn_launches``, ``vit_fpn_device_launches``,
``vit_fpn_max_abs_err``: the same of phase 21;
``context_heads_launches``, ``context_heads_device_launches``,
``context_heads_max_abs_err``: the same of phase 22; E's
row also has
``device_ms`` and ``cudnn_composition_ms`` per call at the flagship set,
and ``val_ms``, ``val_plain_ms``, ``val_bound_ms``, ``val_device_ms`` and
``val_cudnn_composition_ms`` at the val set, all measured in this run),
and last ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""
import contextlib
import copy
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

CONFIG = 'configs/LED_Net/lednet_80k_cityscapes-1024x1024.py'
SIZE = 1024
N_IMAGES = 4
SEED = 0
TOL_KERNEL = 1e-5         # float32 kernels against their plain versions
TOL_MODEL = 1e-3          # whole logits, kernel path against module forms
TRAIN_STEPS = 5           # timed train steps, after one warm-up step
# the zoo phases' timing repeats (10-22), kept few so that the whole
# script stays well inside its 1200 s: each model's forward timed over
# ZOO_TIMED calls after 1, replayed and eager, and
# ZOO_TRAIN_STEPS train steps after a warm-up (3 and 2 before phase 22
# came)
ZOO_TIMED = 2
ZOO_TRAIN_STEPS = 1
TRAIN_BATCH = 6           # the flagship config's train batch
# one train step on the card against the CPU, the bounds that
# tests/test_train_parity.py holds lednet_tpu to torch
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_WEIGHT = dict(atol=1e-4, rtol=5e-3)
TOL_TRAIN_MEAN = dict(atol=1e-5, rtol=0.0)
TOL_TRAIN_VAR = dict(atol=1e-5, rtol=1e-4)
TRAIN_CHECK_SEEDS = (2, 3, 4, 5)   # the card's step against the CPU's
# phase 8: the fabricated Cityscapes tree and the val shape
TREE_TRAIN, TREE_VAL = 12, 4
FRAME_HW = (1024, 2048)
VAL_SHAPE = (8,) + FRAME_HW         # val_batch_size x a Cityscapes frame
# phase 9: the Apple Branch config on a fabricated JPEG tree
BRANCH_CONFIG = 'configs/LED_Net/lednet_80k_branch-512x1024.py'
BRANCH_TRAIN, BRANCH_VAL = 8, 4
BRANCH_FRAME_HW = (1080, 1920)          # a 1920x1080 photo
BRANCH_PORTRAIT_HW = (1440, 1080)       # upright; stored on its side + EXIF 6
BRANCH_TTA_RATIOS = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)   # apple_branch.py
# phase 10: the paper's two same-val baselines at their configs' widths
ZOO = (('DDRNet-23-slim', 'configs/ddrnet/ddrnet_23-slim_cityscapes-1024x1024.py'),
       ('BiSeNetV1 R-18', 'configs/bisenetv1/bisenetv1_r18-d32_cityscapes-1024x1024.py'))
ZOO_WIDE = (('DDRNet-23', 'configs/ddrnet/ddrnet_23_cityscapes-1024x1024.py'),)
ZOO_IMAGES = 2
ZOO_TREE_TRAIN, ZOO_TREE_VAL = 6, 2
# the zoo CLIs' steps, one val at the end (few: the script's clock)
ZOO_ITERS = 10
# phase 11: the next rows of the paper's speed table, PIDNet and STDC, at
# their configs' widths (PIDNet-S and STDC1 in full; the wider ones once)
PID_STDC = (('PIDNet-S', 'configs/pidnet/pidnet-s_cityscapes-1024x1024.py'),
            ('STDC1', 'configs/stdc/stdc1_cityscapes-512x1024.py'))
PID_STDC_WIDE = (('PIDNet-M', 'configs/pidnet/pidnet-m_cityscapes-1024x1024.py'),
                 ('PIDNet-L', 'configs/pidnet/pidnet-l_cityscapes-1024x1024.py'),
                 ('STDC2', 'configs/stdc/stdc2_cityscapes-512x1024.py'))
# phase 12: BiSeNetV2 (its -ohem- config: an OHEM pixel sampler on all five
# heads) and HRNet-W18 in full; HRNet-W18-Small and W48 once; the -amp-
# config's bfloat16 step
BISE_HRNET = (('BiSeNetV2', 'configs/bisenetv2/'
               'bisenetv2_fcn_4xb4-ohem-160k_cityscapes-1024x1024.py'),
              ('HRNet-W18', 'configs/hrnet/fcn_hr18_4xb2-80k_cityscapes-512x1024.py'))
BISE_HRNET_WIDE = (('HRNet-W18-Small',
                    'configs/hrnet/fcn_hr18s_4xb2-80k_cityscapes-512x1024.py'),
                   ('HRNet-W48', 'configs/hrnet/fcn_hr48_4xb2-80k_cityscapes-512x1024.py'))
BISE_AMP = 'configs/bisenetv2/bisenetv2_fcn_4xb4-amp-160k_cityscapes-1024x1024.py'
BISE_HRNET_CONFIGS = ('configs/bisenetv2/*.py',
                      'configs/hrnet/fcn_hr*_cityscapes-512x1024.py')
# phase 13: SegNeXt (ADE20K): T in full, S, B and L once
SEGNEXT = (('SegNeXt-T', 'configs/segnext/segnext_mscan-t_ade20k-512x512.py'),)
SEGNEXT_WIDE = tuple((f'SegNeXt-{v.upper()}',
                      f'configs/segnext/segnext_mscan-{v}_ade20k-512x512.py')
                     for v in 'sbl')
SEGNEXT_CONFIGS = ('configs/segnext/*.py',)
SEGNEXT_START = 2000        # a state step past the LinearLR warm-up (1500)
ADE_TREE_TRAIN, ADE_TREE_VAL = 6, 2
ADE_FRAMES_HW = ((480, 640), (720, 480))      # two aspects, as ADE20K's vary
# phase 14: slide inference: UNet-S5-D16 on DRIVE in full; HRNet-W18 on
# Pascal Context-59 once (a slide forward and the entry points)
SLIDE = (('UNet-S5-D16', 'configs/unet/fcn_unet_s5-d16_drive-64x64.py'),)
PASCAL_HR18 = ('HRNet-W18 PC-59',
               'configs/hrnet/fcn_hr18_4xb4-40k_pascal-context-59-480x480.py')
SLIDE_CONFIGS = ('configs/unet/*.py', 'configs/hrnet/*pascal-context*.py')
SLIDE_CHECK = (4, 64)               # the card's step against the CPU's
DRIVE_FRAME_HW = (584, 565)         # a DRIVE fundus frame
PASCAL_SQUARE_HW = (500, 500)       # 2 x 2 crops of 480 at stride 320
PASCAL_FRAME_HW = (375, 500)        # a 500x375 Pascal Context photo
DRIVE_TREE_TRAIN, DRIVE_TREE_VAL = 4, 2
PASCAL_TREE_TRAIN, PASCAL_TREE_VAL = 8, 2
# phase 15: the configs that the VOC + SBD aug, COCO-Stuff 164k, iSAID,
# LoveDA, Potsdam and Vaihingen datasets unblock; BiSeNetV1 R-50 in full
# (its context path a ResNet-50), R-101 once; three of their data paths
# through the CLIs
DATASET_CONFIGS = ('configs/hrnet/*_voc12aug-512x512.py',
                   'configs/hrnet/*_isaid-896x896.py',
                   'configs/hrnet/*_loveda-512x512.py',
                   'configs/hrnet/*_potsdam-512x512.py',
                   'configs/hrnet/*_vaihingen-512x512.py',
                   'configs/bisenetv1/*_coco-stuff164k-512x512.py')
BISENET_R50 = (('BiSeNetV1 R-50', 'configs/bisenetv1/'
                'bisenetv1_r50-d32_4xb4-160k_coco-stuff164k-512x512.py'),)
BISENET_R101 = (('BiSeNetV1 R-101', 'configs/bisenetv1/'
                 'bisenetv1_r101-d32_4xb4-160k_coco-stuff164k-512x512.py'),)
VOC_HR18 = ('HRNet-W18 VOC aug',
            'configs/hrnet/fcn_hr18_4xb4-20k_voc12aug-512x512.py')
ISAID_HR18S = ('HRNet-W18-Small iSAID',
               'configs/hrnet/fcn_hr18s_4xb4-80k_isaid-896x896.py')
VOC_TREE_TRAIN, VOC_TREE_AUG, VOC_TREE_VAL = 8, 8, 4
VOC_FRAMES_HW = ((375, 500), (500, 375))      # VOC's photos, both aspects
COCO_TREE_TRAIN, COCO_TREE_VAL = 8, 4
COCO_FRAME_HW = (480, 640)
ISAID_TREE_TRAIN, ISAID_TREE_VAL = 8, 2
ISAID_TILE_HW = (896, 896)                    # the converter's patches
# phase 16: the real-time Cityscapes zoo's next five families, at full
# width on the Cityscapes test frame (FRAME_HW); ICNet and CGNet also
# through the CLIs
REALTIME = (('ICNet R-18', 'configs/icnet/icnet_r18-d8_cityscapes-832x832.py'),
            ('Fast-SCNN', 'configs/fastscnn/fast_scnn_cityscapes-512x1024.py'),
            ('ERFNet', 'configs/erfnet/erfnet_cityscapes-512x1024.py'),
            ('CGNet', 'configs/cgnet/cgnet_cityscapes-680x680.py'),
            ('LR-ASPP MobileNetV3-L',
             'configs/mobilenet_v3/lraspp_m-v3-d8_cityscapes-512x1024.py'))
REALTIME_CLIS = ('ICNet R-18', 'CGNet')
# the card's step against the CPU's, (batch, size).  At batch 2 a pyramid
# pool's 1x1 bin (ICNet's ppm0, Fast-SCNN's) is BatchNormed over 2 values a
# channel, (x1 - x2) / sqrt((x1 - x2)^2 + 4 eps) up to a sign: where the two
# nearly tie, its input's float32 rounding comes out up to 1 / (2 sqrt(eps))
# = 158x larger, and the step's float32 distance from float64 is a draw of
# those few channels (tools/torch_port_train_gap.py --grad-trace); over 4
# values a near tie needs all four to agree.  At 128x128, as R50_D8_CHECK,
# for the script's clock: the 1/32 maps are 4x4
REALTIME_CHECK = (4, 128)
CPU_FRAME_HW = (256, 512)     # the card's eval step against the CPU copy's
# phase 17: SCTNet-B, RTFormer-Base, PSPNet R50-D8 and DeepLabV3+ R50-D8 at
# full width on FRAME_HW, RTFormer-Slim once; RTFormer-Base and DeepLabV3+
# through the CLIs; DSNet-S, which the JAX package runs as a module only
SCT_RTF = (
    ('SCTNet-B', 'configs/sctnet/sctnet-b_cityscapes-1024x1024.py'),
    ('RTFormer-Base', 'configs/rtformer/rtformer-base_cityscapes-1024x1024.py'))
R50_D8 = (
    ('PSPNet R50-D8', 'configs/pspnet/pspnet_r50-d8_cityscapes-512x1024.py'),
    ('DeepLabV3+ R50-D8',
     'configs/deeplabv3plus/deeplabv3plus_r50-d8_cityscapes-512x1024.py'))
SCT_RTF_PSP = SCT_RTF + R50_D8
SCT_RTF_PSP_WIDE = (('RTFormer-Slim',
                     'configs/rtformer/rtformer-slim_cityscapes-1024x1024.py'),)
SCT_RTF_PSP_CLIS = ('RTFormer-Base', 'DeepLabV3+ R50-D8')
# the R50-D8 pair's card-against-CPU step, (batch, size): their CPU steps
# at REALTIME_CHECK took about 30 s each (float64, float32 on all threads
# and on one), past phase 17's share of the script's time; at 128x128 the
# D8 trunk's 1/8 map is 16x16, every 1x1 bin still BatchNormed over 4
R50_D8_CHECK = (4, 128)
DSNET_CONFIG = 'configs/dsnet/dsnet-s_cityscapes-1024x1024.py'
# phase 18: the cascade segmentor (OCRNet HR18, PointRend R50) and the first
# transformers (SegFormer MiT-B0 on FRAME_HW; UPerNet Swin-T on an ADE20K
# test frame, ADE_TEST_HW, as the test pipeline resizes a 640x480 photo)
CASCADE_MIT = (
    ('OCRNet HR18', 'configs/ocrnet/ocrnet_hr18_cityscapes-512x1024.py'),
    ('PointRend R50', 'configs/point_rend/pointrend_r50_cityscapes-512x1024.py'),
    ('SegFormer-B0', 'configs/segformer/segformer_mit-b0_cityscapes-1024x1024.py'))
SWIN = (('UPerNet Swin-T', 'configs/swin/upernet_swin-t_ade20k-512x512.py'),)
ADE_TEST_HW = (512, 683)
# the card's eval step against the CPU copy's: Swin at a width of 3 mod 4,
# where flax's 'SAME' patch padding pads one column after
SWIN_CPU_HW = (128, 171)
# the card's step against the CPU's, (batch, size): the 1/32 maps 4x4
PHASE18_CHECK = (4, 128)
# phase 19: the mask-classification heads, K-Net s3 R50-D8 and Mask2Former
# R50, and Mask2Former's deformable pixel decoder (an option, set through
# cfg_options: the config file stays as it is)
KNET_M2F = (('K-Net s3 R50-D8', 'configs/knet/knet_s3_fcn_r50-d8_cityscapes-512x1024.py'),
            ('Mask2Former R50', 'configs/mask2former/'
             'mask2former_r50_cityscapes-512x1024.py'))
MSDEFORM = {'model.decode_head.pixel_decoder': 'msdeform'}
# the card's step against the CPU's, (batch, size): K-Net's D8 maps 16x16,
# Mask2Former's 1/32 maps 4x4
PHASE19_CHECK = (4, 128)
# phase 20: SAN ViT-B16.  As shipped, its side adapter fuses four CLIP
# features and its ViT gives three, which raises in both packages; the ViT's
# token stream is the fourth (mmsegmentation's SAN config sets it), given
# through cfg_options: the config file stays as it is
SAN = (('SAN ViT-B16', 'configs/san/san-vit-b16_cityscapes-512x512.py'),)
SAN_OPTIONS = {'model.image_encoder.out_origin': True}
# the card against its CPU copy: one prompt template, 19 prompts (the
# config's 'vild' has 361), so that the CPU's text tower stays cheap
SAN_SIMPLE = {'model.text_encoder.templates': 'simple'}
# the CLIs: the loader's crops of frames resized by 0.5-2.0 are as high as
# the frame where it is under 1024, and a height off the multiples of 32
# gives a side-adapter grid that is no whole multiple of CLIP's, which
# raises in both packages; every batch is padded to the crop, 1024x1024
SAN_CLI_OPTIONS = dict(SAN_OPTIONS, **{'model.data_preprocessor.size': (1024, 1024)})
# the card's step against the CPU's, (batch, size): the side grid 8x8, CLIP's 4x4
PHASE20_CHECK = (4, 128)
# phase 21's card-against-CPU steps, (batch, size): PointRend-FPN's 1/32
# maps 4x4 at batch 4; Segmenter and DPT at batch 2 (their ViT grid 8x8,
# DPT's resize3 4x4: its BatchNorms over 32 values or more); SETR-MLA's
# ViT-L (306 M parameters, its CPU steps in float64 and float32 the
# phase's costliest) at 2 x 64x64, a 4x4 grid (44.7 s at 2 x 128x128)
PHASE21_CHECK = (4, 128)
VIT_B_CHECK = (2, 128)
SETR_MLA_CHECK = (2, 64)
# phase 21: the ViT segmenters (SETR naive / PUP / MLA on ViT-L, Segmenter,
# DPT and the MLN UPerNet on ViT-B) and the semantic FPN (FPN R50 and
# PointRend over it).  Each is a configs/_base_/models file, composed at run
# time as mmsegmentation's top-level configs of its family compose it
# (compose_base): label, model file, dataset file, schedule, classes, crop
VIT_FPN = (
    ('SETR naive', 'setr_naive.py', 'cityscapes_768x768.py', 'schedule_80k.py',
     19, (768, 768)),
    ('SETR PUP', 'setr_pup.py', 'cityscapes_768x768.py', 'schedule_80k.py',
     19, (768, 768)),
    ('SETR MLA', 'setr_mla.py', 'cityscapes_768x768.py', 'schedule_80k.py',
     19, (768, 768)),
    ('Segmenter ViT-B', 'segmenter_vit-b16_mask.py', 'ade20k.py',
     'schedule_160k.py', 150, (512, 512)),
    ('DPT ViT-B', 'dpt_vit-b16.py', 'ade20k.py', 'schedule_160k.py', 150,
     (512, 512)),
    ('UPerNet ViT-B MLN', 'upernet_vit-b16_ln_mln.py', 'ade20k.py',
     'schedule_80k.py', 150, (512, 512)),
    ('FPN R50', 'fpn_r50.py', 'cityscapes.py', 'schedule_80k.py', 19,
     (512, 1024)),
    ('PointRend-FPN R50', 'pointrend_r50.py', 'cityscapes.py',
     'schedule_80k.py', 19, (512, 1024)),
)
# phase 22: the R50-D8 context heads, one configs/_base_/models file each,
# composed as mmsegmentation's top-level configs of these families compose
# them (compose_base): Cityscapes 512x1024 crops, 80k schedule, 19 classes
CONTEXT_HEADS = tuple(
    (label, f'{name}_r50-d8.py', 'cityscapes.py', 'schedule_80k.py', 19,
     (512, 1024)) for label, name in (
        ('ANNNet R50-D8', 'ann'), ('APCNet R50-D8', 'apcnet'),
        ('CCNet R50-D8', 'ccnet'), ('DANet R50-D8', 'danet'),
        ('DMNet R50-D8', 'dmnet'), ('EMANet R50-D8', 'emanet'),
        ('EncNet R50-D8', 'encnet'), ('GCNet R50-D8', 'gcnet'),
        ('ISANet R50-D8', 'isanet'), ('PSANet R50-D8', 'psanet')))
# NLHead and DNLHead: their files pass ``mode``, which neither package's
# head takes; phase 22 builds each head from its file's decode_head without
# it
NL_HEADS = (('NLHead', 'nonlocal_r50-d8.py'), ('DNLHead', 'dnl_r50-d8.py'))
NL_FEATURE = (2, 2048, 64, 128)     # R50-D8's stage-4 map of a 512x1024 crop
# the three whose train steps phase 22 holds to the CPU's: EMANet (the bases
# buffer, ema_mid_conv's decay), EncNet (the SE loss, encoding_bn) and
# DANet (three losses), at batch 4 (PHASE21_CHECK's) of 64x64: the 1/8 maps
# 8x8, every BatchNorm over 256 values or more, a quarter of the CPU's
# float64 and float32 work of 128x128
CONTEXT_CHECKED = ('EMANet R50-D8', 'EncNet R50-D8', 'DANet R50-D8')
CONTEXT_CHECK = (4, 64)
BF16_U = 2.0 ** -8     # bfloat16's unit roundoff: the amp loss's bound, relative
CE_LOSSES = [dict(type='CrossEntropyLoss', loss_weight=1.0),
             dict(type='CrossEntropyLoss', loss_weight=0.4)]
MIN_ARGMAX_AGREEMENT = 0.999
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12    # H100 SXM TF32 tensor cores, dense
# kernels whose convs run in 3xTF32 on the tensor cores: each float32
# product costs three TF32 products (two for a bf16 operand, exact in TF32)
TENSOR_CORE_KERNELS = ('stem_convs', 'basic_pair')

KERNEL_INFO = {   # name -> (CUDA source, TPU kernel it replaces)
    'normalize_image': ('lednet_tpu_torch/csrc/normalize.cu',
                        'lednet_tpu/ops/pallas/s2d_input.py:80'),
    'stem_convs': ('lednet_tpu_torch/csrc/stem_conv.cu',
                   'lednet_tpu/ops/pallas/stem_conv.py:57'),
    'basic_pair': ('lednet_tpu_torch/csrc/conv_block.cu',
                   'lednet_tpu/ops/pallas/conv_block.py:73'),
    'sesp_block': ('lednet_tpu_torch/csrc/sesp_block.cu',
                   'lednet_tpu/ops/pallas/sesp_pyramid.py:207'),
    'sesp_pyramid': ('lednet_tpu_torch/csrc/sesp_pyramid.cu',
                     'lednet_tpu/ops/pallas/sesp_pyramid.py:79'),
}
OFF_PATH = ('sesp_pyramid',)   # kernels that no model calls
# kernel D's mean ms per call before it was fused (three launches per call),
# measured by this script in three runs on an NVIDIA H100 80GB HBM3 at 700 W
EARLIER_SESP_MS = (0.1155, 0.1265, 0.1262)
# kernels B and C before their tensor-core redesign (B two launches, C four,
# float32 pipes), measured by this script on an NVIDIA H100 80GB HBM3 at 700 W
EARLIER_STEM_MS = 0.1260
EARLIER_PAIR_MS = 0.2622
# kernel E's summed device time (torch.profiler) over each set's 16 calls
# before its Hopper redesign (tools/torch_port_profile.py --pyramid --val on
# an NVIDIA H100 80GB HBM3 at 700 W): the flagship set (phase 3b's pyramid
# shapes, bs 1) and the val set (the same at Runner.val's B=8, W doubled)
EARLIER_PYRAMID_MS = {'flagship': 0.1136, 'val': 1.0361}
# kernel E off its two sets: (B, n, H, W), rates, stride.  W % 4 != 0 takes
# the cp.async path (21, 9, 378, 70, 6, 41); maps smaller than one tile;
# k = 1, 2, 3
RAGGED_PYRAMID = [((2, 16, 13, 21), (1, 2, 3, 4), 1),
                  ((2, 16, 13, 21), (1, 2, 3, 4), 2),
                  ((1, 32, 7, 9), (1, 1, 2, 3), 1),
                  ((2, 32, 250, 378), (1, 1, 1, 1), 1),
                  ((2, 16, 37, 70), (2, 3, 4), 2),
                  ((1, 16, 5, 6), (1, 2), 1),
                  ((3, 8, 40, 41), (3,), 2),
                  ((2, 8, 37, 44), (1, 2, 3), 1)]
# shapes off the main path (which pads to /32) for kernels B and C: batch 2,
# odd and even sizes that are not multiples of the tiles, maps smaller than
# one tile, and the 16-channel width; B's bf16 input is staged by 16-byte
# copies when its width is a multiple of 8 (264) and element by element
# otherwise (378, 45, 9)
RAGGED_STEM = [((2, 3, 250, 378), 32), ((2, 3, 200, 264), 32),
               ((2, 3, 37, 45), 32), ((1, 3, 7, 9), 32),
               ((2, 3, 250, 378), 16)]
RAGGED_PAIR = [((2, 32, 37, 70), 32), ((2, 32, 36, 64), 32),
               ((1, 32, 5, 11), 32), ((2, 16, 37, 70), 16)]


class PhaseError(RuntimeError):
    pass


def say(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        msg = (f'[{name}] FAILED after {time.perf_counter() - t0:.2f} s: '
               f'{type(e).__name__}: {e}')
        say(msg)
        # the end of stderr names the failed phase, its hold and its line
        traceback.print_exc(file=sys.stderr)
        print(msg, file=sys.stderr, flush=True)
        raise PhaseError(name) from e
    say(f'[{name}] ok in {time.perf_counter() - t0:.2f} s')


def rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def cuda_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
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


class EmptyTrace(RuntimeError):
    """A device trace that recorded no kernel at all, its own pads'
    included: the profiler session failed, not the work it wrapped."""


@contextlib.contextmanager
def device_trace(counts):
    """Fill ``counts`` with the CUDA launches of each port kernel that ran
    on the device inside (``kernels.device_launches`` of a CUPTI trace);
    raises EmptyTrace if the trace holds no device kernel at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lednet_tpu_torch.ops import kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_trace()
        yield
        torch.cuda.synchronize()
    events = prof.key_averages()
    if not any(e.device_type == DeviceType.CUDA and e.count for e in events):
        raise EmptyTrace('the device trace recorded no kernel at all')
    counts.update(kernels.device_launches(events))


def traced_forward(model, x8, expected=None):
    """One eager kernel-path forward (preprocess + predict) of the uint8
    images ``x8`` under :func:`device_trace`: (the kernel calls it made, as
    :func:`recording` keeps them; the CUDA launches the trace saw).  A
    forward always launches kernels of its own besides the port's, so an
    EmptyTrace is the profiler's failure: the forward is traced once more
    (seen once in a dozen runs of this script: one session of phase 9 held
    nothing).  So is a trace that falls short of ``expected`` (the launches
    a forward must show) in some kernel and over it in none: a session can
    drop some records (phase 9 once saw 12 of a forward's 22 SESP
    launches); the caller holds the second trace to ``expected``."""
    import torch
    for attempt in (0, 1):
        calls, counts = [], {}
        try:
            with recording(calls), torch.inference_mode(), device_trace(counts):
                x, _, _ = model.data_preprocessor(x8, impl='cuda')
                model.predict(x, 'cuda')
        except EmptyTrace:
            if attempt:
                raise
            say('  the device trace recorded no kernel at all; tracing the '
                'forward again')
            continue
        short = expected is not None and short_trace(counts, expected)
        if attempt or not short:
            return calls, counts
        say(f'  the device trace saw {counts}, not {expected}; tracing the '
            'forward again')


def pad_trace():
    """A profiler session can miss the device activities of its first
    moments (up to three kernels in phase 8; in one run 64 pad kernels and
    the next four): spend them on tiny kernels of no port op, then give the
    tracer time before the traced work."""
    import torch
    pad = torch.zeros(1, device='cuda')
    for _ in range(3):
        for _ in range(64):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.1)


def short_trace(traced, want):
    """A device trace that falls short of ``want`` in some kernel and is
    over it in none: the profiler dropped records (see traced_forward)."""
    return traced != want and all(traced.get(n, 0) <= c
                                  for n, c in want.items())


def synced_ms(fn, reps, warmup=3):
    """Host-clock ms per call of ``fn`` with the device synchronized after
    each call: the latency of one frame at a time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# ---------------------------------------------------------------- capture
def _call_sites():
    import lednet_tpu_torch.models.backbones.lednet as backbone
    import lednet_tpu_torch.models.data_preprocessor as pre
    import lednet_tpu_torch.models.espnet as espnet
    return [(pre, 'normalize_image'), (backbone, 'stem_convs'),
            (backbone, 'basic_pair'), (espnet, 'sesp_block')]


@contextlib.contextmanager
def recording(calls):
    """Record (name, op, args, kwargs) of every kernel op the model calls."""
    saved = []
    for mod, attr in _call_sites():
        op = getattr(mod, attr)
        saved.append((mod, attr, op))

        def rec(*args, _op=op, **kw):
            calls.append((_op.__name__, _op, args, kw))
            return _op(*args, **kw)
        setattr(mod, attr, rec)
    try:
        yield
    finally:
        for mod, attr, op in saved:
            setattr(mod, attr, op)


def work(name, args, kw):
    """(bytes moved, float32 operations, tensor-core TF32 operations) the
    op's function needs: each input read once, each output written once; the
    third is the TF32 work of the 3xTF32 kernels (B, C), else 0."""
    nb = lambda t: t.numel() * t.element_size()
    tensors = [a for a in args if hasattr(a, 'numel')]
    if name == 'normalize_image':
        x = args[0]
        out_bytes = x.numel() * (2 if kw.get('out_dtype') is None or
                                 str(kw['out_dtype']).endswith('bfloat16') else 4)
        return nb(x) + out_bytes, 2 * x.numel(), 0
    if name == 'stem_convs':
        x, w1, b1, w2, b2 = args[:5]
        B, cin, H, W = x.shape
        c1, c2 = w1.shape[0], w2.shape[0]
        h1, w1_ = -(-H // 2), -(-W // 2)
        h2, w2_ = -(-h1 // 2), -(-w1_ // 2)
        out = 4 * B * (c1 * h1 * w1_ + c2 * h2 * w2_)
        conv1 = 2 * B * c1 * h1 * w1_ * cin * 9
        conv2 = 2 * B * c2 * h2 * w2_ * c1 * 9
        bf16 = str(x.dtype).endswith('bfloat16')
        return (sum(nb(t) for t in tensors) + out, conv1 + conv2,
                (2 if bf16 else 3) * conv1 + 3 * conv2)
    if name == 'basic_pair':
        x = args[0]
        B, C, H, W = x.shape
        flops = 4 * 2 * B * H * W * C * C * 9
        return sum(nb(t) for t in tensors) + nb(x), flops, 3 * flops
    if name == 'sesp_block':
        x, dw1 = args[0], args[4]
        B, cin, H, W = x.shape
        k, n = dw1.shape[0], dw1.shape[1]
        C = k * n
        stride = kw.get('stride', 1)
        h2, w2 = -(-H // stride), -(-W // stride)
        v2 = args[5] is not None
        flops = B * (2 * H * W * n * cin + h2 * w2 * (18 * C + C)
                     + (18 * C if v2 else 0) * h2 * w2 + 2 * C * C * h2 * w2)
        return sum(nb(t) for t in tensors) + 4 * B * C * h2 * w2, flops, 0
    if name == 'sesp_pyramid':
        red, dw1, dw2 = args[:3]
        B, n, H, W = red.shape
        C = dw1.shape[0] * n
        stride = kw.get('stride', 1)
        h2, w2 = -(-H // stride), -(-W // stride)
        stages = 1 if dw2 is None else 2
        return (sum(nb(t) for t in tensors) + 4 * B * C * h2 * w2,
                B * (18 * C * stages + C) * h2 * w2, 0)
    raise ValueError(name)


def pyramid_sets(calls, gen):
    """Kernel E's calls (name, op, args, kwargs) by set: ``flagship``, each
    distinct pyramid shape of the SESP calls in ``calls`` (n, H, W, rates,
    stride; their dw1 / dw2 and a seeded random reduced map); ``val``, the
    same at Runner.val's batch and frame width (B=8, W doubled); ``ragged``,
    RAGGED_PYRAMID with seeded random taps.  Each with the v2 stage and
    without."""
    import torch
    from lednet_tpu_torch.ops.kernels import sesp_pyramid
    shapes = {}
    for name, op, args, kw in calls:
        if name == 'sesp_block':
            x, dw1, dw2 = args[0], args[4], args[5]
            shapes.setdefault((dw1.shape[1], *x.shape[2:], tuple(kw['rates']),
                               kw['stride']), (x.shape[0], dw1, dw2))
    operands = {'flagship': [], 'val': [], 'ragged': []}
    for (n, H, W, rates, stride), (B, dw1, dw2) in shapes.items():
        operands['flagship'].append(((B, n, H, W), rates, stride, dw1, dw2))
        operands['val'].append(((VAL_SHAPE[0], n, H, 2 * W), rates, stride,
                                dw1, dw2))
    for shape, rates, stride in RAGGED_PYRAMID:
        dw = [(0.3 * torch.randn((len(rates), shape[1], 3, 3),
                                 generator=gen)).cuda() for _ in range(2)]
        operands['ragged'].append((shape, rates, stride, *dw))
    sets = {}
    for name, entries in operands.items():
        sets[name] = []
        for shape, rates, stride, dw1, dw2 in entries:
            red = torch.randn(shape, generator=gen).cuda()
            for d2 in (dw2, None):
                sets[name].append(('sesp_pyramid', sesp_pyramid,
                                   (red, dw1, d2, rates), {'stride': stride}))
    return sets


def cudnn_pyramid(dw1, dw2, rates, stride):
    """Kernel E's yardstick, never called by the port: cuDNN's nearest
    composition of the pyramid, three calls.  One grouped conv (groups=n)
    computes every branch's HFF sum at once, the k branches' taps merged
    into one zero-padded (2 rmax + 1)^2 kernel per output (summing the
    embedded kernels folds HFF in); one grouped conv (groups=k*n) the v2
    stage, each branch's taps at dilation rate + 1 in a zero-padded kernel;
    one permutation puts the channels in the op's [g][j] order."""
    import torch.nn.functional as F
    k, n = dw1.shape[:2]
    r = max(rates)
    w1 = dw1.new_zeros((n, k, 2 * r + 1, 2 * r + 1))
    for g, d in enumerate(rates):
        w1[:, g:, r - d:r + d + 1:d, r - d:r + d + 1:d] += dw1[g].unsqueeze(1)
    w1 = w1.reshape(n * k, 1, 2 * r + 1, 2 * r + 1)
    if dw2 is not None:
        m = r + 1
        w2 = dw2.new_zeros((n, k, 2 * m + 1, 2 * m + 1))
        for g, d in enumerate(rates):
            w2[:, g, m - d - 1:m + d + 2:d + 1, m - d - 1:m + d + 2:d + 1] = dw2[g]
        w2 = w2.reshape(n * k, 1, 2 * m + 1, 2 * m + 1)

    def run(red):
        y = F.conv2d(red, w1, stride=stride, padding=r, groups=n)
        if dw2 is not None:
            y = F.conv2d(y, w2, padding=r + 1, groups=n * k)
        B, _, h, w = y.shape
        return y.view(B, n, k, h, w).transpose(1, 2).reshape(B, k * n, h, w)
    return run


def device_ms(fn, name, iters=20, sessions=3, counts=False):
    """Device ms per launch of op ``name``'s kernels (their names in
    ``DEVICE_FUNCTIONS``) over ``iters`` calls of fn, from a CUPTI trace
    (and the launches it saw, with ``counts``).  A session now and then
    records no device activity at all (on the card, one of 32 short
    sessions): a session that saw none of the launches is taken again, up
    to ``sessions`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lednet_tpu_torch.ops.kernels import DEVICE_FUNCTIONS
    fns = [f'lednet::{f}' for f in DEVICE_FUNCTIONS[name]]
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_trace()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(f in e.key for f in fns)]
        count = sum(e.count for e in evts)
        if count:
            ms = sum(e.self_device_time_total for e in evts) / 1e3 / count
            return (ms, count) if counts else ms
    raise AssertionError(f'no launch of {fns} in {sessions} traces')


def outputs(res):
    return list(res) if isinstance(res, tuple) else [res]


def shape_of(args):
    return 'x' + 'x'.join(str(s) for s in args[0].shape)


def bounds_ms(name, args, kw):
    """(bound ms, 'bytes' or 'operations', the float32-pipe bound ms): the
    larger of bytes over the memory rate and operations over the peak rate
    of the units the kernel runs them on (TF32 tensor cores for B and C,
    float32 pipes for the rest).  The third is the earlier float32-pipe
    bound of every kernel, for comparison with earlier rows."""
    nbytes, flops, tc_ops = work(name, args, kw)
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf32 = flops / F32_FLOPS_PER_S * 1e3
    to = tc_ops / TF32_FLOPS_PER_S * 1e3 if name in TENSOR_CORE_KERNELS else tf32
    return max(tb, to), 'bytes' if tb >= to else 'operations', max(tb, tf32)


def check_against_plain(name, op, args, kw, tol, errs, log=True):
    """Run op through its kernel and its plain version on the same inputs
    and hold every output to max|kernel - plain| <= tol * max|plain|
    (a line per output when ``log``; ``errs`` gets each max abs error)."""
    import torch
    with torch.inference_mode():
        got = outputs(op(*args, **dict(kw, impl='cuda')))
        torch.cuda.synchronize()
        ref = outputs(op(*args, **dict(kw, impl='plain')))
        torch.cuda.synchronize()
    extra = f' stride={kw["stride"]}' if 'stride' in kw else ''
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f'{name} {shape_of(args)}: {g.shape} '
                                 f'{g.dtype} vs {r.shape} {r.dtype}')
        e_rel, e_abs = rel(g, r), (g.double() - r.double()).abs().max().item()
        if log:
            say(f'  {name} {shape_of(args)} {args[0].dtype}{extra}: max_abs '
                f'{e_abs:.3e} rel {e_rel:.3e} (tol {tol:g})')
        if not e_rel <= tol:
            raise AssertionError(f'{name} {shape_of(args)}{extra} disagrees with '
                                 f'its plain version: max_abs {e_abs:.3e} rel '
                                 f'{e_rel:.3e} (tol {tol:g})')
        errs.append(e_abs)


def train_batch(rng, n, size, edges=None, classes=19):
    """n seeded BGR uint8 crops of ``size`` (h, w), or size x size, and int64
    labels of ``classes`` classes with about 2% at 255 (ignored).  With
    ``edges`` (``GenerateEdge``'s width, for PIDNet) the labels come in
    32-pixel blocks, about 5% of them ignored, as a dict with the
    ``gt_edge_map`` that ``GenerateEdge`` gives them."""
    import torch
    h, w = (size, size) if isinstance(size, int) else size
    imgs = torch.from_numpy(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))
    if edges is None:
        lbl = np.where(rng.random((n, h, w)) < 0.02, 255,
                       rng.integers(0, classes, (n, h, w)))
        return imgs, torch.from_numpy(lbl.astype(np.int64))
    from lednet_tpu_torch.datasets.transforms import GenerateEdge
    coarse = (n, -(-h // 32), -(-w // 32))
    lbl = np.where(rng.random(coarse) < 0.05, 255,
                   rng.integers(0, classes, coarse))
    lbl = np.ascontiguousarray(lbl.repeat(32, 1).repeat(32, 2)[:, :h, :w])
    generate = GenerateEdge(edge_width=edges)
    edge = np.stack([generate({'gt_seg_map': m})['gt_edge_map'] for m in lbl])
    return imgs, dict(gt_seg_map=torch.from_numpy(lbl.astype(np.int64)),
                      gt_edge_map=torch.from_numpy(edge.astype(np.int64)))


def edge_width(cfg):
    """The width of ``GenerateEdge`` in ``cfg``'s train pipeline, or None."""
    for t in cfg.get('train_pipeline') or []:
        if t['type'] == 'GenerateEdge':
            return t.get('edge_width', 3)
    return None


def to_device(labels, device):
    """Labels, or a dict of label maps, on ``device``."""
    if isinstance(labels, dict):
        return {k: v.to(device) for k, v in labels.items()}
    return labels.to(device)


def train_once(cfg, device, imgs, lbl, seed, dtype=None, start=None):
    """One train step of a seeded model of ``cfg`` on ``device`` (its
    weights cast to ``dtype`` if given), at the state step
    :func:`start_step` gives: (loss, state_dict on the CPU).  ``lbl``:
    labels or a dict of label maps.  ``start``: that seeded model, built
    on the CPU, copied in place of building it again (the seeded
    initialisation of a full-width model costs seconds of host time)."""
    import dataclasses
    import torch
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                         make_train_step)
    if start is None:
        model = init_model(cfg, device=device,
                           generator=torch.Generator().manual_seed(seed))
    else:
        model = copy.deepcopy(start).to(device)
    if dtype is not None:
        model.to(dtype)
    opt, sched = build_optimizer(model, cfg.optim_wrapper, cfg.param_scheduler)
    step = make_train_step(model, opt, model.data_preprocessor)
    state = dataclasses.replace(create_train_state(model, opt, sched),
                                step=start_step(cfg))
    _, logs = step(state, imgs.to(device), to_device(lbl, device))
    return logs['loss'].item(), {k: v.detach().cpu()
                                 for k, v in model.state_dict().items()}


def start_step(cfg):
    """The state step of the card-against-CPU train step: 0, or
    SEGNEXT_START where a ``LinearLR`` warm-up starts below 1e-3 of the
    base lr (SegNeXt's, 1e-6: at step 0 the update is below float32's
    resolution of the weights, and the comparison would hold nothing)."""
    ends = [c.get('end', 0) for c in cfg.get('param_scheduler') or []
            if c.get('type') == 'LinearLR' and c.get('start_factor', 1.0) < 1e-3]
    if not ends:
        return 0
    if max(ends) >= SEGNEXT_START:
        raise AssertionError(f'the warm-up ends at {max(ends)}, past '
                             f'SEGNEXT_START')
    return SEGNEXT_START


def train_distance(run, ref):
    """(|loss - loss_ref|, max |diff| of the weights, of the BatchNorm
    stats, every tensor's largest share of its TOL_TRAIN_* bound as (share,
    name), largest first: a share above 1 is outside it)."""
    import torch
    (loss, sd), (loss_ref, sd_ref) = run, ref
    # on the card where there is one: the same float64 arithmetic, exactly
    # rounded on either device, seconds faster for ViT-L's 306 M weights
    dev = 'cuda' if torch.cuda.is_available() else 'cpu'
    worst = {'weight': 0.0, 'bn_stat': 0.0}
    shares = []
    for k, want in sd_ref.items():
        if k.endswith('num_batches_tracked'):
            continue
        tol = (TOL_TRAIN_MEAN if k.endswith('running_mean') else
               TOL_TRAIN_VAR if k.endswith('running_var') else TOL_TRAIN_WEIGHT)
        want = want.to(dev, torch.float64)
        d = (sd[k].to(dev, torch.float64) - want).abs()
        kind = 'bn_stat' if 'running' in k else 'weight'
        worst[kind] = max(worst[kind], d.max().item())
        shares.append(((d / (tol['atol'] + tol['rtol'] * want.abs())).max().item(), k))
    return (abs(loss - loss_ref), worst['weight'], worst['bn_stat'],
            sorted(shares, reverse=True))


def hold_train(name, card, cpu, bounds):
    """Hold a train step on the card to the CPU's: the loss within
    TOL_TRAIN_LOSS, and the weights and BatchNorm stats within their
    TOL_TRAIN_* where ``bounds`` names them ('weights', 'bn_stats')."""
    dl, dw, ds, shares = train_distance(card, cpu)
    worst = {'weights': max((r for r, k in shares if 'running' not in k),
                            default=0.0),
             'bn_stats': max((r for r, k in shares if 'running' in k),
                             default=0.0)}
    say(f'  {name}: |loss diff| {dl:.3e} (tol {TOL_TRAIN_LOSS:g}), max |diff| '
        f'weights {dw:.3e}, BatchNorm stats {ds:.3e}; nearest their bound: ' +
        ', '.join(f'{k} {r:.3f}' for r, k in shares[:3]) + '; held: loss, ' +
        ', '.join(bounds))
    if not (dl <= TOL_TRAIN_LOSS and all(worst[b] <= 1.0 for b in bounds)):
        raise AssertionError(f'{name}: card and CPU disagree')


@contextlib.contextmanager
def decisions(kept, flips=None, pin=False, points_only=False):
    """A train step's discrete decisions: the pixels each OHEM loss keeps,
    the sign of each ReLU's input, each max pool's choice, PIDHead's
    boundary gate (the pixels whose ``sigmoid(d) > 0.8`` keep their label in
    its fourth loss), the pixels each ``OHEMPixelSampler`` keeps, the
    candidates PointHead keeps as its training points and Mask2Former as
    its loss's points (``top_uncertain``), K-Net's hard masks
    (``KernelUpdateHead.hard_mask``), Mask2Former's attention masks
    (``MaskFormerHead.attention_mask``), its Hungarian assignment
    (``MaskFormerHead.assign``), and SAN's points and assignment
    (``SideAdapterCLIPHead``'s, the same functions).
    Inside, with ``flips`` None, each is appended to ``kept`` in call
    order; else ``flips[kind]`` counts where the step decides otherwise
    than the next of ``kept``, and with ``pin`` the step follows
    ``kept``.  With ``points_only`` only PointHead's choice is taken (its
    eval subdivision's too: the points it re-predicts)."""
    import torch
    import torch.nn.functional as F
    from lednet_tpu_torch.models.decode_heads.knet_head import KernelUpdateHead
    from lednet_tpu_torch.models.decode_heads.maskformer_head import \
        MaskFormerHead
    from lednet_tpu_torch.models.decode_heads.pid_head import PIDHead
    from lednet_tpu_torch.models.decode_heads.point_head import PointHead
    from lednet_tpu_torch.models.decode_heads.san_head import \
        SideAdapterCLIPHead as SAN
    from lednet_tpu_torch.models.losses.cross_entropy import OhemCrossEntropy
    from lednet_tpu_torch.structures import OHEMPixelSampler
    threshold, relu, max_pool = OhemCrossEntropy.threshold, F.relu, F.max_pool2d
    boundary_gate, keep_mask = PIDHead.boundary_gate, OHEMPixelSampler.keep_mask
    top_uncertain = PointHead.top_uncertain
    hard_mask, attention_mask = (KernelUpdateHead.hard_mask,
                                 MaskFormerHead.attention_mask)
    assign = MaskFormerHead.assign
    recorded = iter(list(kept))

    def decide(kind, own):
        if flips is None:
            kept.append(own.cpu())
            return own
        ref = next(recorded).to(own.device)
        flips[kind] = flips.get(kind, 0) + int((own != ref).sum())
        return ref if pin else own

    def ohem(self, logits, labels, ignore_index=None):
        t, valid, p_gt = threshold(self, logits, labels, ignore_index)
        keep = decide('ohem', valid & (p_gt < t))
        # p_gt 0 below the threshold 0.5 keeps exactly ``keep``'s pixels
        return (t.new_tensor(0.5), valid,
                torch.where(keep, 0.0, 1.0).to(p_gt.dtype))

    def rectify(x, inplace=False):
        return x * decide('relu', x > 0).to(x.dtype)

    def pool(x, kernel_size, stride=None, padding=0, dilation=1,
             ceil_mode=False, return_indices=False):
        out, idx = max_pool(x, kernel_size, stride, padding, dilation,
                            ceil_mode, return_indices=True)
        idx = decide('max_pool', idx)
        out = x.flatten(2).gather(2, idx.flatten(2)).view_as(out)
        return (out, idx) if return_indices else out

    def gate(self, d_logit):
        return decide('gate', boundary_gate(self, d_logit))

    def sampled(self, seg_logits, seg_label):
        return decide('sampler', keep_mask(self, seg_logits, seg_label))

    def points(self, uncertainty, k):
        # the decision is the set of candidates kept; they go on in
        # candidate order, not by uncertainty, so that the MLP's ReLU
        # decisions line up point by point from one step to another
        own = torch.zeros_like(uncertainty, dtype=torch.bool).scatter_(
            1, top_uncertain(self, uncertainty, k), True)
        chosen = decide('points', own)
        return torch.topk(chosen.to(uncertainty.dtype), k, dim=1, sorted=False
                          ).indices.sort(dim=1).values

    def hard(self, mask_preds):
        return decide('hard_mask', hard_mask(self, mask_preds))

    def attend(self, interm):
        return decide('attn_mask', attention_mask(self, interm))

    def matched(self, cost):
        return decide('matching', assign(self, cost))
    patches = [(PointHead, 'top_uncertain', points)]
    if not points_only:
        patches += [
            (OhemCrossEntropy, 'threshold', ohem), (F, 'relu', rectify),
            (F, 'max_pool2d', pool), (PIDHead, 'boundary_gate', gate),
            (OHEMPixelSampler, 'keep_mask', sampled),
            (MaskFormerHead, 'top_uncertain', points),
            (SAN, 'top_uncertain', points), (KernelUpdateHead, 'hard_mask', hard),
            (MaskFormerHead, 'attention_mask', attend),
            (MaskFormerHead, 'assign', matched), (SAN, 'assign', matched)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        yield
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)


def float32_bounds(cpu_loss, cpu_weights, cpu_stats):
    """The bounds of a float32 step's distance from float64: of its |loss
    diff|, and of its weights' and BatchNorm stats' largest shares of
    TOL_TRAIN_WEIGHT and TOL_TRAIN_MEAN / TOL_TRAIN_VAR.  Each is the
    larger of phase 6's bound and 3 x the CPU float32 step's own distance
    on the same inputs and decisions (``cpu_*``: the larger of its runs on
    all threads and on one, two orders of its sums).  The loss and the running
    means are forward sums of large activations, and a model's float32
    gradients carry its forward's rounding: on either device that alone
    can pass phase 6's absolute bounds (the CPU misses PIDNet-S's
    ``spp.processes`` running mean; STDC1's gradients on the card are
    2-2.5x less exact than the CPU's from the logits down,
    ``tools/torch_port_train_gap.py --grad-trace``)."""
    return (max(TOL_TRAIN_LOSS, 3 * cpu_loss), max(1.0, 3 * cpu_weights),
            max(1.0, 3 * cpu_stats))


def hold_float32(name, card, cpu_runs, exact):
    """Hold a float32 train step on the card, its decisions pinned, to the
    float64 one (``exact``): its loss, weights and BatchNorm stats within
    :func:`float32_bounds` of the CPU float32 steps' (``cpu_runs``: the same
    step on all threads and on one) largest distance from the same float64
    step."""
    def distance(run):
        dl, _, _, shares = train_distance(run, exact)
        return (dl, max(r for r, k in shares if 'running' not in k),
                max((r for r, k in shares if 'running' in k), default=0.0),
                shares)
    loss, weights, stats, shares = distance(card)
    cpu_loss, cpu_weights, cpu_stats = (max(d) for d in zip(
        *(distance(run)[:3] for run in cpu_runs)))
    bounds = float32_bounds(cpu_loss, cpu_weights, cpu_stats)
    say(f'  {name}, float32 vs the CPU float64 (the CPU: the larger of its '
        f'float32 steps on all threads and on one): |loss diff| the card '
        f'{loss:.3e}, the CPU {cpu_loss:.3e} (bound {bounds[0]:.3e}); as '
        f'shares of phase 6\'s bounds, weights the card {weights:.3f}, the '
        f'CPU {cpu_weights:.3f} (bound {bounds[1]:.3f}), BatchNorm stats the '
        f'card {stats:.3f}, the CPU {cpu_stats:.3f} (bound {bounds[2]:.3f}); '
        'the card\'s nearest: ' + ', '.join(
            f'{k} {r:.3f}' for r, k in shares[:3]) +
        '; held: loss, weights, BatchNorm stats')
    strays = [what for what, v, bound in zip(
        ('loss', 'weights', 'BatchNorm stats'), (loss, weights, stats), bounds)
              if not v <= bound]
    if strays:
        raise AssertionError(f'{name}: the card\'s float32 {", ".join(strays)} '
                             'stray from float64')


def randomize_norms(model, gen):
    """Non-trivial BatchNorm affine parameters and running stats, and
    GroupNorm and LayerNorm affine parameters."""
    import torch
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=gen))


def seed_gammas(model, gen):
    """The attention heads' residual gammas (DANet's ``pam_gamma`` /
    ``cam_gamma``, CCNet's ``cca_gamma``), which start at 0 and would hide
    their attention, drawn in [0.5, 1.5]."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('_gamma'):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))


def check_logits(name, out, ref):
    """max |out - ref| <= TOL_KERNEL x max |ref| and argmax agreement 1."""
    err = (out.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
    say(f'  {name}: max_abs {err:.3e} (tol {TOL_KERNEL:g} x max|logit| '
        f'{scale:.3f}), argmax agreement {agree:.6f}')
    if not (err <= TOL_KERNEL * scale and agree == 1.0):
        raise AssertionError(f'{name} disagrees with the eager kernel path')


def call_cli(args):
    """Run a port CLI's ``main`` on its argv in this process, under torch's
    default TF32 flags (cuDNN convs TF32, matmuls float32), as a fresh
    process would run it; returns its stdout lines.  A raise is re-raised
    with the end of its output.  Every phase calls the CLIs so: a process
    of its own costs 20-25 s before its first step on the card's host."""
    import gc
    import importlib.util
    import io
    import torch
    path = args[0]
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    out = io.StringIO()
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with contextlib.redirect_stdout(out):
            cli.main(list(args[1:]))
    except Exception as e:
        raise AssertionError(f'{path} raised {e!r}:\n{out.getvalue()[-2000:]}') from e
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
        gc.collect()
        torch.cuda.empty_cache()
    return out.getvalue().splitlines()


def train_log(lines):
    """{step: (loss, iter_time, data_time)} of the console lines and
    {step: metrics} of the val lines."""
    import ast
    import re
    iters, vals = {}, {}
    for line in lines:
        m = re.match(r'Iter \[(\d+)/\d+\]', line)
        if m:
            field = {k: float(v) for k, v in
                     re.findall(r'(?:^|  )(loss|time|data_time): (\S+?)s?(?=  |$)',
                                line)}
            iters[int(m.group(1))] = (field['loss'], field['time'],
                                      field['data_time'])
        m = re.match(r'val @ (\d+): (\{.*\})$', line)
        if m:
            vals[int(m.group(1))] = ast.literal_eval(m.group(2))
    return iters, vals


def entry_points(model, card, expected):
    """Phase 8: the train/val/test entry points on a fabricated Cityscapes
    tree (``expected``: phase 3's CUDA launches of one forward); returns the
    kernels' wrapper launches and device launches of the in-process train +
    val run."""
    import shutil
    import tempfile
    import torch
    from lednet_tpu_torch.apis import inference_model
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.datasets import imageio
    from lednet_tpu_torch.datasets.synthetic import make_cityscapes_tree
    from lednet_tpu_torch.engine.optim import build_lr_schedule
    from lednet_tpu_torch.engine.runner import Runner
    from lednet_tpu_torch.ops import kernels
    from torch.profiler import ProfilerActivity, profile

    tmp = tempfile.mkdtemp(prefix='lednet_smoke_')
    try:
        t0 = time.perf_counter()
        data = make_cityscapes_tree(os.path.join(tmp, 'cityscapes'),
                                    n_train=TREE_TRAIN, n_val=TREE_VAL,
                                    size_hw=FRAME_HW, seed=SEED)
        say(f'  fabricated {TREE_TRAIN} train and {TREE_VAL} val frames at '
            f'{FRAME_HW[1]}x{FRAME_HW[0]} in {time.perf_counter() - t0:.2f} s')

        # kernels A-D at the val shape, against their plain versions
        gen = torch.Generator().manual_seed(SEED + 8)
        x8 = torch.randint(0, 256, VAL_SHAPE + (3,), generator=gen,
                           dtype=torch.uint8).cuda()
        with torch.inference_mode():
            x, _, _ = model.data_preprocessor(x8, impl='cuda')
            model.predict(x, 'cuda')          # warm-up at the new shape
        calls, per_forward = traced_forward(model, x8, expected)
        say(f'  CUDA launches of one forward at {VAL_SHAPE} (device trace): '
            f'{per_forward}')
        if per_forward != expected:
            raise AssertionError(f'the device ran {per_forward} kernel launches '
                                 f'at {VAL_SHAPE}, not those of phase 3, '
                                 f'{expected}')
        errs = {}
        for name, op, args, kw in calls:
            check_against_plain(name, op, args, kw,
                                0.0 if name == 'normalize_image' else TOL_KERNEL,
                                errs.setdefault(name, []))
        missing = [n for n in KERNEL_INFO if n not in errs and n not in OFF_PATH]
        if missing:
            raise AssertionError(f'the forward at {VAL_SHAPE} called no {missing}')
        del calls, x, x8
        torch.cuda.empty_cache()

        options = [f'{k}.dataset.data_root={data}' for k in
                   ('train_dataloader', 'val_dataloader', 'test_dataloader')]
        work = os.path.join(tmp, 'work')
        train = ['tools/torch_port_train.py', CONFIG, '--work-dir', work,
                 '--cfg-options', *options, 'train_cfg.val_interval=10',
                 'default_hooks.checkpoint.interval=10',
                 'default_hooks.logger.interval=5']
        t0 = time.perf_counter()
        iters, vals = train_log(call_cli(train + ['train_cfg.max_iters=20']))
        say(f'  train CLI, 20 steps: {time.perf_counter() - t0:.2f} s; loss at '
            + ', '.join(f'{k}: {v[0]:.4f}' for k, v in iters.items())
            + f'; val at {sorted(vals)}: {vals.get(20)}')
        if sorted(iters) != [5, 10, 15, 20] or not all(
                np.isfinite(v[0]) for v in iters.values()):
            raise AssertionError(f'train log lines: {iters}')
        files = sorted(os.listdir(work))
        if sorted(vals) != [10, 20] or not {'iter_10.pth', 'iter_20.pth',
                                            'last_checkpoint'} <= set(files):
            raise AssertionError(f'val at {sorted(vals)}, files {files}')

        t0 = time.perf_counter()
        lines = call_cli(train + ['train_cfg.max_iters=30', '--resume'])
        resumed = [l for l in lines if l.startswith('resumed from')]
        iters2, vals2 = train_log(lines)
        cfg = Config.fromfile(CONFIG)
        lr20 = build_lr_schedule(cfg.param_scheduler,
                                 cfg.optim_wrapper.optimizer.lr)(20)
        say(f'  resume CLI to 30: {time.perf_counter() - t0:.2f} s; '
            f'{resumed}; steps {sorted(iters2)}; val at {sorted(vals2)}')
        want = f'iter_20.pth at step 20 (iter 20), lr {lr20:.6e}'
        if len(resumed) != 1 or want not in resumed[0] or \
                sorted(iters2) != [25, 30] or sorted(vals2) != [30]:
            raise AssertionError(f'resume: {resumed}, want {want!r}')

        t0 = time.perf_counter()
        lines = call_cli(['tools/torch_port_test.py', CONFIG,
                          os.path.join(work, 'iter_20.pth'), '--work-dir',
                          os.path.join(tmp, 'test'), '--cfg-options', *options])
        tested = json.loads(lines[-1])
        say(f'  test CLI on iter_20.pth: {time.perf_counter() - t0:.2f} s; '
            f'{tested} (val at step 20: {vals[20]})')
        if tested != vals[20]:
            raise AssertionError('the test CLI does not reproduce the val at '
                                 'step 20')

        # the repaired fault: no cv2 or PIL on a PNG path or a 1280x720 frame
        blocked = {m: sys.modules.get(m) for m in ('cv2', 'PIL')}
        sys.modules.update(dict.fromkeys(blocked))
        try:
            frame = os.path.join(data, 'leftImg8bit', 'val', 'aachen',
                                 'aachen_000000_000019_leftImg8bit.png')
            res_png = inference_model(model, frame)
            small = np.random.default_rng(SEED).integers(
                0, 256, (720, 1280, 3), dtype=np.uint8)
            res_720 = inference_model(model, small)
        finally:
            for m, mod in blocked.items():
                if mod is None:
                    sys.modules.pop(m, None)
                else:
                    sys.modules[m] = mod
        say(f'  inference_model on a PNG path: {res_png["pred_sem_seg"].shape}; '
            f'on a 1280x720 array: {res_720["pred_sem_seg"].shape} via '
            f'{res_720["metainfo"]["img_shape"]}')
        if res_png['pred_sem_seg'].shape != FRAME_HW or \
                res_720['pred_sem_seg'].shape != (720, 1280) or not (
                    np.isfinite(res_png['seg_logits']).all()
                    and np.isfinite(res_720['seg_logits']).all()):
            raise AssertionError('inference_model on a file or a 720p frame')
        if not np.array_equal(imageio.imread(frame).shape, FRAME_HW + (3,)):
            raise AssertionError('the PNG frame did not decode')

        # the loader's host work per sample, by transform, on one thread
        from lednet_tpu_torch.datasets import build_dataloader
        from lednet_tpu_torch.datasets.loader import sample_rng
        train_set = build_dataloader(dict(
            cfg.train_dataloader, dataset=dict(cfg.train_dataloader.dataset,
                                               data_root=data))).dataset
        spent = {}
        for i in range(TRAIN_BATCH):
            results, rng = train_set.get_data_info(i), sample_rng(SEED, i)
            for t in train_set.pipeline.transforms:
                t0 = time.perf_counter()
                results = t(results, rng)
                name = type(t).__name__
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        say(f'  loader host time per train sample (one thread, mean of '
            f'{TRAIN_BATCH}): {sum(spent.values()) / TRAIN_BATCH * 1e3:.1f} ms; '
            + ', '.join(f'{k} {v / TRAIN_BATCH * 1e3:.1f}' for k, v in spent.items()))

        # the card's own numbers: the train loop in this process, its idle
        # share over 10 iterations, then val at 8 x 1024 x 2048
        cfg.merge_from_dict(dict(
            {o.split('=')[0]: data for o in options},
            **{'train_cfg.max_iters': 20, 'train_cfg.val_interval': 0,
               'default_hooks.checkpoint.interval': 1000,
               'default_hooks.logger.interval': 5}))
        runner = Runner(cfg, work_dir=os.path.join(tmp, 'perf'), seed=SEED)
        logged, window = {}, {}
        console = runner.logger.console

        def watch(step, max_iters, scalars, **kw):
            console(step, max_iters, scalars, **kw)
            logged[step] = (kw['iter_time'], kw['data_time'])
            if step == 5:            # the device was synchronized at the log
                window['prof'] = profile(activities=[ProfilerActivity.CUDA])
                window['prof'].__enter__()
                window['t0'] = time.perf_counter()
            elif step == 15:
                window['wall'] = time.perf_counter() - window['t0']
                window['prof'].__exit__(None, None, None)
        runner.logger.console = watch
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        runner.train()          # module forms: no port kernel launches
        train_peak = torch.cuda.max_memory_allocated()
        device = {}
        with device_trace(device):
            t0 = time.perf_counter()
            metrics = runner.val()
            val_wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        say(f'  in-process train (20 steps) + val: wrapper launches {launches}, '
            f'CUDA launches {device}; val {metrics}')
        # val ran one eager warm-up forward per capture and replayed one
        # graph per chunk of val_batch_size frames
        chunks = -(-TREE_VAL // VAL_SHAPE[0])
        forwards = runner.eval_step().captures + chunks
        if short_trace(device, {n: c * forwards for n, c in expected.items()}):
            # the profiler dropped records (see traced_forward): val is
            # traced once more, replaying the graphs it captured
            say(f'  the device trace saw {device}, not {forwards} forwards; '
                'tracing val again')
            captures, device = runner.eval_step().captures, {}
            with device_trace(device):
                again = runner.val()
            forwards = runner.eval_step().captures - captures + chunks
            say(f'  val traced again: CUDA launches {device}; val {again}')
            if again != metrics:
                raise AssertionError(f'val traced again gave {again}, not '
                                     f'{metrics}')
        if not all(c for n, c in launches.items() if n not in OFF_PATH) or \
                device != {n: c * forwards for n, c in expected.items()}:
            raise AssertionError(f'val launched {launches} (device {device}), '
                                 f'not every kernel of the path {forwards} '
                                 f'times over')
        from torch.autograd import DeviceType
        events = [e for e in window['prof'].key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(getattr(e, 'self_device_time_total', 0.0) or
                   getattr(e, 'self_cuda_time_total', 0.0) for e in events) / 1e6
        steady = [logged[k] for k in (10, 15, 20)]
        it_s = sum(t for t, _ in steady) / 3
        wait_s = sum(d for _, d in steady) / 3
        step = runner.eval_step()
        x8 = torch.randint(0, 256, VAL_SHAPE + (3,), generator=gen,
                           dtype=torch.uint8).cuda()
        with torch.inference_mode():
            val_ms = cuda_ms(lambda: step(x8), reps=5, warmup=2)
        say(f'  train iteration, bs 6 at 1024x1024 crops, 4 loader threads, '
            f'steps 6-20: {it_s * 1e3:.3f} ms, of it {wait_s * 1e3:.3f} ms '
            f'waiting on the loader and {(it_s - wait_s) * 1e3:.3f} ms the '
            f'rest; on {card}')
        say(f'  device idle share over train steps 6-15 (torch.profiler): '
            f'{max(0.0, 1 - busy / window["wall"]):.4f} (busy {busy * 1e3:.1f} '
            f'of {window["wall"] * 1e3:.1f} ms); on {card}')
        say(f'  val: eval step at {VAL_SHAPE}: {val_ms:.3f} ms '
            f'({VAL_SHAPE[0] * 1e3 / val_ms:.2f} images/s); runner.val() on '
            f'{TREE_VAL} frames {val_wall:.3f} s; on {card}')
        say(f'  peak memory allocated: train {train_peak / 2**30:.3f} GiB, '
            f'train + val {peak / 2**30:.3f} GiB; on {card}')
        del runner, step, x8
        torch.cuda.empty_cache()
        return launches, device
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def branch_eval_shapes(cfg):
    """The eval step's input shapes on the branch path, padded to the
    bucket: val (``val_batch_size`` frames after the test ``Resize``) and
    each test-time view (one frame at each ratio), per frame size."""
    from lednet_tpu_torch.datasets.transforms.transforms import rescale_size
    bucket = int(cfg.get('eval_pad_multiple', 128))
    vb = int(cfg.get('val_batch_size', 8))
    scale = cfg.test_dataloader.dataset.pipeline[1]['scale']
    ratios = [t['scale_factor'] for t in cfg.tta_pipeline[1]['transforms'][0]]
    if tuple(ratios) != BRANCH_TTA_RATIOS:
        raise AssertionError(f'the config views at {ratios}')

    def padded(size_wh):
        w, h = size_wh
        return h + (-h) % bucket, w + (-w) % bucket
    shapes = {}
    for h, w in (BRANCH_FRAME_HW, BRANCH_PORTRAIT_HW):
        shapes[f'val {w}x{h}'] = (vb,) + padded(rescale_size((w, h), scale))
        for r in ratios:
            shapes[f'tta {w}x{h} x{r}'] = (1,) + padded(
                rescale_size((w, h), (int(w * r), int(h * r))))
    return shapes


def branch_path(card, expected):
    """Phase 9: the Apple Branch config through the train and test entry
    points on a fabricated JPEG tree (``expected``: phase 3's CUDA launches
    of one forward); returns the kernels' wrapper launches, device launches
    and largest errors against their plain versions on this path."""
    import shutil
    import tempfile
    import torch
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.datasets import build_dataloader, imageio
    from lednet_tpu_torch.datasets.loader import sample_rng
    from lednet_tpu_torch.datasets.synthetic import make_branch_tree
    from lednet_tpu_torch.engine.runner import Runner
    from lednet_tpu_torch.engine.state import float32_math
    from lednet_tpu_torch.ops import kernels

    tmp = tempfile.mkdtemp(prefix='lednet_branch_')
    try:
        t0 = time.perf_counter()
        data = make_branch_tree(os.path.join(tmp, 'branch'), BRANCH_TRAIN,
                                BRANCH_VAL, size_hw=BRANCH_FRAME_HW,
                                portrait_hw=BRANCH_PORTRAIT_HW, seed=SEED)
        (h, w), (ph, pw) = BRANCH_FRAME_HW, BRANCH_PORTRAIT_HW
        say(f'  fabricated {BRANCH_TRAIN} train and {BRANCH_VAL} val JPEG '
            f'frames at {w}x{h} and one {pw}x{ph} portrait frame (stored '
            f'{ph}x{pw}, EXIF orientation 6, in both lists) with the port\'s '
            f'writer in {time.perf_counter() - t0:.2f} s')

        # JPEG decode per frame, then the train pipeline's host time per
        # sample by transform, on one thread
        jpegs = sorted(os.listdir(os.path.join(data, 'JPEGImages')))
        t0 = time.perf_counter()
        decoded = {n: imageio.imread(os.path.join(data, 'JPEGImages', n)).shape
                   for n in jpegs}
        decode_ms = (time.perf_counter() - t0) / len(jpegs) * 1e3
        if decoded.pop('portrait_0000.jpg') != BRANCH_PORTRAIT_HW + (3,) or \
                set(decoded.values()) != {BRANCH_FRAME_HW + (3,)}:
            raise AssertionError(f'decoded shapes {decoded}')
        say(f'  JPEG decode (imageio.imread, color): {decode_ms:.2f} ms per '
            f'frame, mean of {len(jpegs)}; the portrait frame reads upright; '
            f'on the host of {card}')
        cfg = Config.fromfile(BRANCH_CONFIG)
        options = {f'{k}.dataset.{key}': value
                   for k in ('train_dataloader', 'val_dataloader', 'test_dataloader')
                   for key, value in (('data_root', data), ('img_suffix', '.jpg'))}
        cfg.merge_from_dict(options)
        train_set = build_dataloader(dict(cfg.train_dataloader)).dataset
        spent = {}
        for i in range(BRANCH_TRAIN):
            results, rng = train_set.get_data_info(i), sample_rng(SEED, i)
            for t in train_set.pipeline.transforms:
                t0 = time.perf_counter()
                results = t(results, rng)
                name = type(t).__name__
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        say(f'  loader host time per train sample (one thread, mean of '
            f'{BRANCH_TRAIN}): {sum(spent.values()) / BRANCH_TRAIN * 1e3:.1f} ms; '
            + ', '.join(f'{k} {v / BRANCH_TRAIN * 1e3:.1f}' for k, v in spent.items())
            + f'; on the host of {card}')

        # kernels A-D at every eval shape of the path, against their plain
        # versions, with a device trace of one forward at each
        kmodel = init_model(BRANCH_CONFIG, device='cuda',
                            generator=torch.Generator().manual_seed(SEED + 9))
        gen = torch.Generator().manual_seed(SEED + 9)
        randomize_norms(kmodel, gen)
        errs = {}
        for label, shape in branch_eval_shapes(cfg).items():
            x8 = torch.randint(0, 256, shape + (3,), generator=gen,
                               dtype=torch.uint8).cuda()
            shape_errs = {}
            with torch.inference_mode():
                x, _, _ = kmodel.data_preprocessor(x8, impl='cuda')
                kmodel.predict(x, 'cuda')          # warm-up at the new shape
            calls, per_forward = traced_forward(kmodel, x8, expected)
            if per_forward != expected:
                raise AssertionError(f'{label} {shape}: the device ran '
                                     f'{per_forward}, not {expected}')
            for name, op, args, kw in calls:
                rels = shape_errs.setdefault(name, [])
                check_against_plain(name, op, args, kw,
                                    0.0 if name == 'normalize_image' else TOL_KERNEL,
                                    rels, log=False)
                errs.setdefault(name, []).extend(rels)
            missing = [n for n in KERNEL_INFO if n not in shape_errs and n not in OFF_PATH]
            if missing:
                raise AssertionError(f'the forward at {shape} called no {missing}')
            say(f'  {label}: {shape}: ' + ', '.join(
                f'{n} x{len(e)} max_abs {max(e):.2e}' for n, e in shape_errs.items())
                + f' (held: normalize exact, others {TOL_KERNEL:g} x max|plain|)')
            del calls, x, x8
        del kmodel
        torch.cuda.empty_cache()

        # the CLIs: train 20 steps, test on iter_20.pth, test --tta
        opts = [f'{k}={v}' for k, v in options.items()]
        work = os.path.join(tmp, 'work')
        t0 = time.perf_counter()
        iters, vals = train_log(call_cli(
            ['tools/torch_port_train.py', BRANCH_CONFIG, '--work-dir', work,
             '--cfg-options', *opts, 'train_cfg.max_iters=20',
             'train_cfg.val_interval=10', 'default_hooks.checkpoint.interval=10',
             'default_hooks.logger.interval=5']))
        say(f'  train CLI, 20 steps: {time.perf_counter() - t0:.2f} s; loss at '
            + ', '.join(f'{k}: {v[0]:.4f}' for k, v in iters.items())
            + f'; val at {sorted(vals)}: {vals.get(10)}, {vals.get(20)}')
        files = sorted(os.listdir(work))
        if sorted(iters) != [5, 10, 15, 20] or not all(
                np.isfinite(v[0]) for v in iters.values()) or \
                sorted(vals) != [10, 20] or not {
                    'iter_10.pth', 'iter_20.pth', 'last_checkpoint'} <= set(files):
            raise AssertionError(f'train log {iters}, val at {sorted(vals)}, '
                                 f'files {files}')
        test = ['tools/torch_port_test.py', BRANCH_CONFIG,
                os.path.join(work, 'iter_20.pth'), '--work-dir',
                os.path.join(tmp, 'test'), '--cfg-options', *opts]
        t0 = time.perf_counter()
        tested = json.loads(call_cli(test)[-1])
        say(f'  test CLI on iter_20.pth: {time.perf_counter() - t0:.2f} s; '
            f'{tested} (val at step 20: {vals[20]})')
        if tested != vals[20]:
            raise AssertionError('the test CLI does not reproduce the val at '
                                 'step 20')
        t0 = time.perf_counter()
        tta_cli = json.loads(call_cli(test + ['--tta'])[-1])
        say(f'  test CLI --tta on iter_20.pth: {time.perf_counter() - t0:.2f} s; '
            f'{tta_cli}')
        if set(tta_cli) != set(tested) or not all(
                np.isfinite(v) for v in tta_cli.values()):
            raise AssertionError(f'--tta metrics {tta_cli}')

        # the card's own numbers from a Runner in this process
        cfg.merge_from_dict({'train_cfg.max_iters': 20, 'train_cfg.val_interval': 0,
                             'default_hooks.checkpoint.interval': 1000,
                             'default_hooks.logger.interval': 5})
        runner = Runner(cfg, work_dir=os.path.join(tmp, 'perf'), seed=SEED)
        logged = {}
        console = runner.logger.console

        def watch(step, max_iters, scalars, **kw):
            console(step, max_iters, scalars, **kw)
            logged[step] = (kw['iter_time'], kw['data_time'])
        runner.logger.console = watch
        torch.cuda.reset_peak_memory_stats()
        runner.train()
        train_peak = torch.cuda.max_memory_allocated()
        steady = [logged[k] for k in (10, 15, 20)]
        it_s = sum(t for t, _ in steady) / 3
        wait_s = sum(d for _, d in steady) / 3
        say(f'  train iteration, bs 2 of 512x512 crops padded to 512x1024, '
            f'2 loader threads, steps 6-20: {it_s * 1e3:.3f} ms, of it '
            f'{wait_s * 1e3:.3f} ms waiting on the loader; on {card}')

        # test and test --tta, launches counted over both (the main path of
        # this phase), then both again, timed
        step = runner.eval_step()
        plain_pipeline = runner.cfg['test_dataloader']['dataset']['pipeline']
        pipelines = (('test', plain_pipeline), ('test --tta', cfg['tta_pipeline']))

        def test_run(which):
            runner.cfg['test_dataloader']['dataset']['pipeline'] = dict(pipelines)[which]
            c0, t0 = step.captures, time.perf_counter()
            metrics = runner.test()
            torch.cuda.synchronize()
            return metrics, time.perf_counter() - t0, step.captures - c0
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        device, counted = {}, {}
        with device_trace(device):
            for which, _ in pipelines:
                counted[which] = test_run(which)
        launches = kernels.launch_counts()
        test_peak = torch.cuda.max_memory_allocated()
        n_frames = BRANCH_VAL + 1
        calls = 2 + n_frames * 2 * len(BRANCH_TTA_RATIOS)   # val chunks + views
        forwards = calls + sum(c for _, _, c in counted.values())
        say(f'  test + test --tta (traced): wrapper launches {launches}, CUDA '
            f'launches {device}; graphs captured: test {counted["test"][2]}, '
            f'--tta {counted["test --tta"][2]}; metrics {counted["test"][0]}, '
            f'--tta {counted["test --tta"][0]}')
        if all(c for n, c in launches.items() if n not in OFF_PATH) and \
                device != {n: c * forwards for n, c in expected.items()}:
            # a profiler session can drop the device records of some
            # forwards (whole forwards of this one, twice in a dozen runs):
            # trace both passes again, which now replay the captured graphs
            say(f'  the device trace saw {device}, not {forwards} forwards; '
                'tracing both passes again')
            device = {}
            with device_trace(device):
                again = {which: test_run(which) for which, _ in pipelines}
            if any(again[w][0] != counted[w][0] or again[w][2] for w in again):
                raise AssertionError(f'test + --tta traced again gave {again}, '
                                     f'not {counted} without captures')
            forwards = calls
            say(f'  test + test --tta (traced again): CUDA launches {device}')
        if not all(c for n, c in launches.items() if n not in OFF_PATH) or \
                device != {n: c * forwards for n, c in expected.items()}:
            raise AssertionError(f'test + --tta launched {launches} (device '
                                 f'{device}), not every kernel of the path '
                                 f'{forwards} times over')
        timed = {which: test_run(which) for which, _ in pipelines}
        for which, (metrics, wall, captures) in timed.items():
            if metrics != counted[which][0] or captures:
                raise AssertionError(f'{which} gave {counted[which][0]}, then '
                                     f'{metrics} and captured {captures} graphs '
                                     f'again (the step keeps {len(step._graphs)})')
            say(f'  Runner.test ({which}) on {n_frames} frames: {wall:.3f} s '
                f'({wall / n_frames * 1e3:.1f} ms per frame), {captures} graphs '
                f'captured; on {card}')

        # one frame's views through Runner.predict_tta: the replayed graphs
        # against the eager kernel path, then the time per frame of each
        runner.cfg['test_dataloader']['dataset']['pipeline'] = cfg['tta_pipeline']
        views = None
        for batch in build_dataloader(dict(runner.cfg['test_dataloader'])):
            views = batch['tta_views']
            break

        def eager(x):
            with float32_math():
                return step.forward(x)
        runner.model.eval()
        with torch.inference_mode():
            probs, pred = runner.predict_tta(views, step)
            eager_probs, eager_pred = runner.predict_tta(views, eager)
            check_logits(f'{len(views)} views merged, replay vs eager: mean '
                         f'probabilities', probs, eager_probs)
            if not torch.equal(pred, eager_pred):
                raise AssertionError('the merged prediction differs from the '
                                     'eager kernel path')
            replay_ms = synced_ms(lambda: runner.predict_tta(views, step),
                                  reps=3, warmup=1)
            eager_ms = synced_ms(lambda: runner.predict_tta(views, eager),
                                 reps=3, warmup=1)
        say(f'  one test-time-augmented {w}x{h} frame (12 views, host clock): '
            f'replayed graphs {replay_ms:.1f} ms, eager kernel path '
            f'{eager_ms:.1f} ms; on {card}')
        say(f'  peak memory allocated: train {train_peak / 2**30:.3f} GiB, '
            f'test + test --tta {test_peak / 2**30:.3f} GiB (reserved now '
            f'{torch.cuda.memory_reserved() / 2**30:.3f} GiB, graphs held '
            f'{len(step._graphs)}); on {card}')
        del runner, step
        torch.cuda.empty_cache()
        return launches, device, {n: max(e) for n, e in errs.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def class_default(module_cfg, name):
    """The default of ``name`` in the constructor of the port's module
    that ``module_cfg`` builds (SCTNet's ``drop_path_rate`` is 0.1 where
    its config sets none), or None."""
    import inspect
    import lednet_tpu_torch.models  # noqa: F401  (registers the modules)
    from lednet_tpu_torch.registry import MODELS
    param = inspect.signature(MODELS.get(module_cfg['type'])).parameters.get(name)
    return None if param is None else param.default


def without_dropout(cfg):
    """cfg options that set dropout 0 in the decode head (every stage of a
    cascade) and every auxiliary head where the config has some, every
    rate of :func:`drop_rates` 0 (stochastic depth, the ViT's dropout and
    attention dropout, Segmenter's head's stochastic depth) and the
    backbone's ``dropout_ratio`` 0 where it drops units (ERFNet's blocks;
    two RNG streams cannot drop the same units or samples), and a note
    saying so ('' when none had any)."""
    import inspect
    import lednet_tpu_torch.models  # noqa: F401  (registers the modules)
    from lednet_tpu_torch.registry import MODELS
    aux = cfg.model.get('auxiliary_head') or []
    one_aux = not isinstance(aux, (list, tuple))      # a head, not a list
    decode = cfg.model.decode_head
    cascade = isinstance(decode, (list, tuple))       # every stage's
    heads = (list(decode) if cascade else [decode]) + (
        [aux] if one_aux else list(aux))
    # SAN's head drops nothing and takes no dropout_ratio (Mask2Former's
    # passes it on through **kwargs)
    heads = [h for h in heads if any(
        n == 'dropout_ratio' or p.kind == p.VAR_KEYWORD for n, p in
        inspect.signature(MODELS.get(h['type'])).parameters.items())]
    extra, notes = {}, []
    if any(h.get('dropout_ratio', 0.1) for h in heads):
        if cascade:
            extra['model.decode_head'] = [dict(h, dropout_ratio=0.0)
                                          for h in decode]
        else:
            extra['model.decode_head.dropout_ratio'] = 0.0
        if aux:
            extra['model.auxiliary_head'] = (
                dict(aux, dropout_ratio=0.0) if one_aux else
                [dict(h, dropout_ratio=0.0) for h in aux])
        notes.append('dropout 0 in every head')
    rates = drop_rates(cfg)
    for key in rates:
        extra[f'model.{key}'] = 0.0
    if rates:
        notes.append(', '.join(rates) + ' 0')
    backbone = cfg.model.get('backbone') or {}      # SAN has an image_encoder
    if backbone.get('dropout_ratio'):
        extra['model.backbone.dropout_ratio'] = 0.0
        notes.append("the backbone's dropout 0")
    return extra, (', ' + ' and '.join(notes) + ' for this comparison only'
                   if notes else '')


def drop_rates(cfg):
    """The nonzero training-time rates of ``cfg``'s backbone (stochastic
    depth; the ViT's ``drop_rate`` and ``attn_drop_rate``) and of its
    decode head where it is one module (Segmenter's ``drop_path_rate``),
    set in the config or by the module's class default (SCTNet's and
    Segmenter's 0.1): ``{'backbone.drop_path_rate': 0.1, ...}``."""
    out = {}
    for part in ('backbone', 'decode_head'):
        module = cfg.model.get(part) or {}      # SAN has an image_encoder
        if not isinstance(module, dict) or 'type' not in module:
            continue                            # a cascade's list of heads
        names = ('drop_path_rate',) if part == 'decode_head' else (
            'drop_path_rate', 'drop_rate', 'attn_drop_rate')
        for name in names:
            rate = module.get(name, class_default(module, name))
            if isinstance(rate, (int, float)) and rate:
                out[f'{part}.{name}'] = rate
    return out


def cpu_copy(model):
    """``model`` (its weights, buffers, config and preprocessor) copied to
    the CPU: no second model built and seeded (ViT-L's 306 M parameters
    took seconds to draw); its eval step's graphs are left out."""
    step = model.__dict__.pop('_eval_step', None)
    try:
        return copy.deepcopy(model).cpu()
    finally:
        if step is not None:
            model._eval_step = step


def once(card, label, config, x8, gen, cpu_x8=None):
    """One forward of ``config``'s model (a path or a ``Config``; seeded
    weights, non-trivial BatchNorm stats) on the uint8 images ``x8`` in
    the mode of its ``test_cfg``: the eval step's replayed graph against
    the eager kernel path (``check_logits``), each timed once; with
    ``cpu_x8``, the replayed graph on those images against the model
    copied to the CPU within TOL_MODEL."""
    import torch
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.engine import make_eval_step
    model = init_model(config, device='cuda', generator=gen)
    randomize_norms(model, gen)
    mode = model.test_cfg.get('mode', 'whole')
    predict = model.predict_slide if mode == 'slide' else model.predict
    step = make_eval_step(model, model.data_preprocessor, mode)

    def eager():
        return predict(model.data_preprocessor(x8)[0])
    with torch.inference_mode():
        check_logits(f'{label} replay vs eager kernel path ({mode})', step(x8),
                     eager())
        replay_ms = cuda_ms(lambda: step(x8), reps=1, warmup=0)
        eager_ms = cuda_ms(eager, reps=1, warmup=0)
    say(f'  {label} forward {"x".join(str(n) for n in x8.shape[:3])} '
        f'({mode}), one call each: replayed graph {replay_ms:.3f} ms, eager '
        f'{eager_ms:.3f} ms; on {card}')
    if cpu_x8 is not None:
        cpu_model = cpu_copy(model)
        with torch.inference_mode():
            want = make_eval_step(cpu_model, cpu_model.data_preprocessor,
                                  mode)(cpu_x8).double()
            got = step(cpu_x8.cuda()).cpu().double()
        e = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(-1) == want.argmax(-1)).double().mean().item()
        say(f'  {label} {"x".join(str(n) for n in cpu_x8.shape[:3])}: replayed '
            f'graph on the card vs the model copied to the CPU rel {e:.3e} '
            f'(tol {TOL_MODEL:g}), argmax agreement {agree:.6f}')
        if not (got.shape == want.shape and e <= TOL_MODEL
                and agree >= MIN_ARGMAX_AGREEMENT):
            raise AssertionError(f'{label}: the card and the CPU disagree')
        del cpu_model
    del model, step
    torch.cuda.empty_cache()


def loader_crop(cfg):
    """The crop the config's train loader gives: its pipeline's
    ``RandomCrop`` size, through dataset wrappers (phase 16's configs crop
    1024x1024, the base's, and pass their own ``crop_size`` to the
    preprocessor only)."""
    ds = cfg.train_dataloader.dataset
    while 'pipeline' not in ds:
        ds = ds['datasets'][0] if 'datasets' in ds else ds['dataset']
    crops = [t['crop_size'] for t in ds['pipeline'] if t['type'] == 'RandomCrop']
    if len(crops) != 1:
        raise AssertionError(f'train pipeline crops {crops}')
    return tuple(crops[0])


def timed_train(card, label, cfg, rng, gen):
    """The train step of ``cfg`` (a seeded model) at the config's batch and
    its loader's crop (:func:`loader_crop`) on the card, TF32 off: one
    warm-up step and ZOO_TRAIN_STEPS timed (CUDA events; every log finite),
    and peak memory."""
    import torch
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                         make_train_step)
    from lednet_tpu_torch.models.segmentors.cascade_encoder_decoder import \
        predicting_head_cfg
    batch = cfg.train_dataloader.batch_size
    crop = loader_crop(cfg)
    edges = edge_width(cfg)
    train_model = init_model(cfg, device='cuda', generator=gen)
    opt, sched = build_optimizer(train_model, cfg.optim_wrapper,
                                 cfg.param_scheduler)
    train = make_train_step(train_model, opt, train_model.data_preprocessor)
    state = create_train_state(train_model, opt, sched)
    t_imgs, t_lbl = train_batch(rng, batch, crop, edges,
                                predicting_head_cfg(cfg.model)['num_classes'])
    t_imgs, t_lbl = t_imgs.cuda(), to_device(t_lbl, 'cuda')
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = []
    for i in range(1 + ZOO_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = train(state, t_imgs, t_lbl)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        vals = {k: v.item() for k, v in logs.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f'{label} step {state.step}: {vals}')
    say(f'  {label} step {state.step} logs: ' + ', '.join(
        f'{k} {v:.5f}' for k, v in vals.items()))
    ms = sum(times[1:]) / ZOO_TRAIN_STEPS
    rates = drop_rates(cfg)
    say(f'  {label} train step, bs {batch} at {crop[0]}x{crop[1]}'
        f'{" with edge maps" if edges else ""}'
        f'{" with " + ", ".join(f"{k} {v:g}" for k, v in rates.items()) + " active" if rates else ""}'
        f' (TF32 off): '
        f'{ms:.3f} ms/step ({batch * 1000 / ms:.2f} img/s) over '
        f'{ZOO_TRAIN_STEPS} steps after a warm-up; on {card}')
    say(f'  {label} train step peak memory allocated: '
        f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, of it '
        f'{held / 2**30:.3f} GiB allocated before the first step (this '
        f'model, its batch and what earlier phases hold); on {card}')
    del train_model, opt, train, state, t_imgs, t_lbl, logs
    torch.cuda.empty_cache()


def zoo_models(card, models=ZOO, wide=ZOO_WIDE, frame_hw=(SIZE, SIZE),
               check=(2, 256), cpu_hw=None, check_options=None):
    """Phases 10-16, inference and training of ``models`` at their
    configs' widths (seeded weights, non-trivial BatchNorm stats; phase 10:
    DDRNet-23-slim and BiSeNetV1 R-18, phase 11: PIDNet-S and STDC1, phase
    12: BiSeNetV2 and HRNet-W18, phase 13: SegNeXt-T, phase 14: UNet-S5-D16
    in slide mode, phase 15: BiSeNetV1 R-50, phase 16: the five of
    REALTIME), and one forward of each of ``wide``, on frames of
    ``frame_hw`` (padded to a multiple of 32 where ``inference_model`` pads
    them), in the mode of each model's ``test_cfg`` (whole or slide); with
    ``cpu_hw``, the eval step's replayed graph and the eager kernel path on
    a frame of that size against the model copied to the CPU; each train
    step timed at the config's batch and its loader's crop; the card's
    train step against the CPU's at ``check`` (batch, size; None: not
    held), with ``check_options`` merged into its config.  An entry of ``models`` is
    (label, config) or (label, config, cfg options).  Returns the kernels'
    wrapper launches and device launches of their main path and kernel A's
    largest error at float32 output."""
    import torch
    from lednet_tpu_torch.apis import inference_model, init_model
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.engine import make_eval_step
    from lednet_tpu_torch.models.segmentors.cascade_encoder_decoder import \
        predicting_head_cfg
    from lednet_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(SEED + 10)
    rng = np.random.default_rng(SEED + 10)
    imgs = [rng.integers(0, 256, frame_hw + (3,), dtype=np.uint8)
            for _ in range(ZOO_IMAGES)]
    pad = [(0, (-n) % 32) for n in frame_hw]
    x_dev = torch.from_numpy(np.pad(imgs[0], pad + [(0, 0)])[None]).cuda()
    shape = 'x'.join(str(n) for n in x_dev.shape[:3])
    x_val = torch.randint(0, 256, VAL_SHAPE + (3,), generator=gen,
                          dtype=torch.uint8).cuda()
    launches, device, a_errs = {}, {}, []
    for label, config, *options in models:
        t0 = time.perf_counter()
        options = options[0] if options else {}
        model = init_model(config, device='cuda', generator=gen,
                           cfg_options=options)
        randomize_norms(model, gen)
        seed_gammas(model, gen)
        classes = predicting_head_cfg(model.cfg.model)['num_classes']
        pre = model.data_preprocessor
        mode = model.test_cfg.get('mode', 'whole')
        predict = model.predict_slide if mode == 'slide' else model.predict
        if pre.out_dtype != torch.float32:
            raise AssertionError(f'{label}: the preprocessor emits {pre.out_dtype}')

        # kernel A at float32 output, at the forward's and the val shape
        for x in (x_dev, x_val):
            calls = []
            with recording(calls), torch.inference_mode():
                pre(x, impl='cuda')
            if [c[0] for c in calls] != ['normalize_image'] or \
                    calls[0][3].get('out_dtype') != torch.float32:
                raise AssertionError(f'{label}: preprocessing called {calls}')
            check_against_plain('normalize_image', *calls[0][1:], 0.0, a_errs)

        # the main path: inference_model through the kernels, counted.  An
        # EmptyTrace is the profiler's failure (see traced_forward): the
        # run goes again with a fresh eval step, which captures again; so
        # does one whose trace is short of some launches and over in none
        for attempt in (0, 1):
            kernels.reset_launch_counts()
            traced = {}
            try:
                with device_trace(traced):
                    res = inference_model(model, imgs, impl='cuda')
            except EmptyTrace:
                if attempt:
                    raise
                say('  the device trace recorded no kernel at all; running '
                    'inference_model again with a fresh eval step')
                del model.__dict__['_eval_step']
                continue
            forwards = ZOO_IMAGES + model._eval_step.captures
            want = {n: forwards if n == 'normalize_image' else 0
                    for n in traced}
            if attempt or not short_trace(traced, want):
                break
            say(f'  the device trace saw {traced}, not {want}; running '
                'inference_model again with a fresh eval step')
            del model.__dict__['_eval_step']
        counts = kernels.launch_counts()
        say(f'  {label}: wrapper launches {counts}; CUDA launches on the '
            f'device ({forwards} forwards, {ZOO_IMAGES} replayed) {traced}')
        if not counts['normalize_image'] or traced != want or any(
                c for n, c in counts.items() if n != 'normalize_image'):
            raise AssertionError(f'{label}: launches {counts}, device {traced}, '
                                 f'not {want}')
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
            device[n] = device.get(n, 0) + traced[n]

        # the kernel path against the module forms, TF32 off; then under
        # torch's defaults (cuDNN TF32 on) through inference_model
        plain = inference_model(model, imgs, impl='plain')
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = inference_model(model, imgs)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        for name, got in (('kernel path', res), ('inference_model under '
                                                 "torch's defaults", tf32)):
            for i, (a, b) in enumerate(zip(got, plain)):
                la, lb = a['seg_logits'], b['seg_logits']
                e = np.abs(la - lb).max() / np.abs(lb).max()
                agree = (a['pred_sem_seg'] == b['pred_sem_seg']).mean()
                say(f'  {label} image {i}: {name} vs float32 module forms rel '
                    f'{e:.3e} (tol {TOL_MODEL:g}), argmax agreement '
                    f'{agree:.6f}, max|logit| {np.abs(lb).max():.3f}')
                if la.shape != frame_hw + (classes,) or not (
                        np.isfinite(la).all() and e <= TOL_MODEL
                        and agree >= MIN_ARGMAX_AGREEMENT):
                    raise AssertionError(f'{label} image {i}: {name} disagrees')

        # the eval graph against the eager kernel path, then both timed;
        # the memory that the first call (warm-up and capture) and an eager
        # forward take above what was held before them, and the graph's
        # pool that the step keeps
        step = make_eval_step(model, pre, mode)

        def eager():
            x, _, _ = pre(x_dev, impl='cuda')
            return predict(x, 'cuda')
        with torch.inference_mode():
            mem = {}
            for name, fn in (('capture', lambda: step(x_dev)), ('eager', eager)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                out = fn()
                torch.cuda.synchronize()
                mem[name] = (torch.cuda.max_memory_allocated() - held) / 2**30
                mem[name + ' kept'] = (torch.cuda.memory_allocated() - held) / 2**30
                if name == 'capture':
                    replayed = out
            check_logits(f'{label} replay vs eager kernel path ({mode})',
                         replayed, out)
            del replayed, out
            # one warm-up each: the graph was captured and replayed, and
            # the eager path run, just above
            replay_ms = cuda_ms(lambda: step(x_dev), reps=ZOO_TIMED, warmup=1)
            eager_ms = cuda_ms(eager, reps=ZOO_TIMED, warmup=1)
        say(f'  {label} forward {shape} ({mode}): replayed graph '
            f'{replay_ms:.3f} ms ({1000 / replay_ms:.1f} img/s); on {card}')
        say(f'  {label} forward {shape} ({mode}): eager kernel path '
            f'{eager_ms:.3f} ms ({1000 / eager_ms:.1f} img/s); on {card}')
        say(f'  {label} forward {shape} memory above what was held before: '
            f'peak of the first call (eager warm-up + capture) '
            f'{mem["capture"]:.3f} GiB, the graph\'s pool and input kept '
            f'{mem["capture kept"]:.3f} GiB; peak of an eager forward '
            f'{mem["eager"]:.3f} GiB; on {card}')
        if cpu_hw is not None:
            small = torch.from_numpy(rng.integers(0, 256, (1,) + cpu_hw + (3,),
                                                  dtype=np.uint8))
            cpu_model = cpu_copy(model)
            at = "x".join(str(n) for n in small.shape[:3])
            with torch.inference_mode():
                # PointHead's subdivision re-predicts its most uncertain
                # points: recorded on the CPU, counted on the card's eager
                # path (a graph cannot capture the comparison's copies)
                points, flips = [], {}
                with decisions(points, points_only=True):
                    want = make_eval_step(cpu_model, cpu_model.data_preprocessor,
                                          mode)(small).double()
                x_small = small.cuda()
                with decisions(points, flips, points_only=True):
                    eager_out = predict(pre(x_small, impl='cuda')[0], 'cuda')
                chose = flips.get('points', 0)
                for name, got in (('replayed graph', step(x_small)),
                                  ('eager kernel path', eager_out)):
                    got = got.cpu().double()
                    e = ((got - want).abs().max() / want.abs().max()).item()
                    agree = (got.argmax(-1) == want.argmax(-1)).double().mean().item()
                    say(f'  {label} {at}: {name} on the card vs the model copied '
                        f'to the CPU rel {e:.3e} (tol {TOL_MODEL:g}'
                        f'{", not held: the points differ" if chose else ""}), '
                        f'argmax agreement {agree:.6f}')
                    if not (got.shape == want.shape and (chose or e <= TOL_MODEL)
                            and agree >= MIN_ARGMAX_AGREEMENT):
                        raise AssertionError(f'{label}: the card and the CPU '
                                             'disagree')
                if chose:
                    # a point within rounding of the k-th uncertainty is
                    # chosen on one device only and re-predicted there: a
                    # jump, not an error.  Held with the CPU's points
                    with decisions(points, {}, True, points_only=True):
                        got = predict(pre(x_small, impl='cuda')[0], 'cuda')
                    got = got.cpu().double()
                    e = ((got - want).abs().max() / want.abs().max()).item()
                    agree = (got.argmax(-1) == want.argmax(-1)).double().mean().item()
                    say(f'  {label} {at}: of {sum(p.numel() for p in points)} '
                        f'subdivision candidates, {chose} chosen or left '
                        f'otherwise on the card; the eager kernel path with '
                        f'the CPU\'s points '
                        f'vs the CPU rel {e:.3e} (tol {TOL_MODEL:g}), argmax '
                        f'agreement {agree:.6f}')
                    if not (got.shape == want.shape and e <= TOL_MODEL
                            and agree >= MIN_ARGMAX_AGREEMENT):
                        raise AssertionError(f'{label}: the card and the CPU '
                                             'disagree with the points pinned')
            del cpu_model
        if label == models[0][0]:
            calls = []
            with recording(calls), torch.inference_mode():
                pre(x_dev, impl='cuda')
            _, op, args, kw = calls[0]
            with torch.inference_mode():
                a_ms = cuda_ms(lambda: op(*args, **dict(kw, impl='cuda')), 20)
                a_plain = cuda_ms(lambda: op(*args, **dict(kw, impl='plain')), 20)
            bound, by, _ = bounds_ms('normalize_image', args, kw)
            say(f'  kernel A at float32 output, {shape}: {a_ms:.4f} ms, '
                f'plain {a_plain:.4f} ms, bound {bound:.4f} ms ({by}); on {card}')
        del model, step, res, plain, tf32
        torch.cuda.empty_cache()
        say(f'  {label} inference checks and timing: '
            f'{time.perf_counter() - t0:.1f} s (host clock)')

    # the wider variants once each, eager and replayed
    for label, config in wide:
        once(card, label, config, x_dev, gen)

    # training: the config's batch at its crop size, then the card's step
    # against the CPU's
    for label, config, *options in models:
        cfg = Config.fromfile(config)
        cfg.merge_from_dict(options[0] if options else {})
        edges = edge_width(cfg)
        classes = predicting_head_cfg(cfg.model)['num_classes']
        t0 = time.perf_counter()
        timed_train(card, label, cfg, rng, gen)
        t1 = time.perf_counter()
        if check is None:
            say(f'  {label} timed train steps {t1 - t0:.1f} s (host clock)')
            continue

        extra, note = without_dropout(cfg)
        n_check, size = check
        at = f'{n_check}x{size}x{size}'
        extra['model.data_preprocessor.size'] = (size, size)
        extra.update(check_options or {})
        cfg.merge_from_dict(extra)
        s_imgs, s_lbl = train_batch(np.random.default_rng(SEED + 11), n_check,
                                    size, edges, classes)
        if start_step(cfg):
            note += f', at state step {start_step(cfg)} (past the warm-up)'
        # float64 holds the step's arithmetic to phase 6's bounds.  A float32
        # step is held with its discrete decisions (OHEM's kept pixels, ReLU
        # signs, max pool choices, PIDHead's boundary gate, the heads' points,
        # hard masks, attention masks and matching) pinned to the CPU
        # float64 step's: a value within rounding of a threshold or kink
        # decides otherwise, a jump of the step, not an error.  Its loss,
        # weights and BatchNorm stats are held to float64 within
        # float32_bounds
        runs, kept, flips = {}, [], {}
        start = init_model(cfg, device='cpu',
                           generator=torch.Generator().manual_seed(SEED + 11))
        seed_gammas(start, torch.Generator().manual_seed(SEED + 12))
        with decisions(kept):
            runs['cpu', torch.float64] = train_once(cfg, 'cpu', s_imgs, s_lbl,
                                                    SEED + 11, torch.float64,
                                                    start)
        for dev, dtype, pin in (('cpu', torch.float32, True),
                                ('cuda', torch.float64, False),
                                ('cuda', torch.float32, True),
                                ('cuda', torch.float32, False)):
            n = flips[dev, dtype, pin] = {}
            with torch.backends.cudnn.flags(enabled=False), \
                    decisions(kept, n, pin):
                runs[dev, dtype, pin] = train_once(cfg, dev, s_imgs, s_lbl,
                                                   SEED + 11, dtype, start)
        cpu64 = runs['cpu', torch.float64]
        say(f'  {label} one step, {at}: of {len(kept)} calls that decide '
            '(OHEM, ReLU, max pool, boundary gate, pixel sampler, point '
            'selection, hard masks, attention masks, matching), elements '
            'decided otherwise than in the '
            'CPU float64 step: ' + '; '.join(
                f'{which} {flips[key]}' for which, key in (
                    ('the CPU float32', ('cpu', torch.float32, True)),
                    ('the card float64', ('cuda', torch.float64, False)),
                    ('the card float32', ('cuda', torch.float32, False)))))
        hold_train(f'{label} one step, {at}, float64, the card (PyTorch\'s '
                   f'own CUDA convs) vs the CPU{note}',
                   runs['cuda', torch.float64, False], cpu64,
                   ('weights', 'bn_stats'))
        dl, dw, ds, shares = train_distance(runs['cuda', torch.float32, False],
                                            cpu64)
        say(f'  {label} one step, {at}, the card float32 vs the CPU '
            f'float64, its own decisions (not held): |loss diff| '
            f'{dl:.3e}, max |diff| weights {dw:.3e}, BatchNorm stats {ds:.3e}; '
            'nearest their bound: ' + ', '.join(f'{k} {r:.3f}'
                                                for r, k in shares[:3]))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with decisions(kept, {}, True):
                cpu_one = train_once(cfg, 'cpu', s_imgs, s_lbl, SEED + 11,
                                     torch.float32, start)
        finally:
            torch.set_num_threads(threads)
        hold_float32(f'{label} one step, {at}, decisions pinned{note}',
                     runs['cuda', torch.float32, True],
                     (runs['cpu', torch.float32, True], cpu_one), cpu64)
        del start, runs
        say(f'  {label} timed train steps {t1 - t0:.1f} s, the card\'s step '
            f'against the CPU\'s {time.perf_counter() - t1:.1f} s (host clock)')
    return launches, device, max(a_errs)


def bf16_step(card, config=BISE_AMP):
    """Phase 12: the ``bf16 = True`` config's train step (``amp=True``, the
    Runner's reading of it) at the config's batch and crop on the card,
    beside its float32 step from the same seeded weights and batch, both
    with dropout 0 (two steps draw different dropout masks): the first
    step's loss of each, then TRAIN_STEPS timed steps after it, peak
    memory.  Holds every loss finite, the master weights and their
    gradients float32, and the bfloat16 loss within BF16_U of the float32
    one, relatively (the bound of ``tests/test_torch_port_bisenetv2_hrnet.py``
    for the loss)."""
    import torch
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                         make_train_step)
    cfg = Config.fromfile(config)
    if not cfg.get('bf16'):
        raise AssertionError(f'{config} does not set bf16')
    cfg.merge_from_dict(without_dropout(cfg)[0])
    batch = cfg.train_dataloader.batch_size
    crop = tuple(cfg.model.data_preprocessor.size)
    imgs, lbl = (t.cuda() for t in train_batch(np.random.default_rng(SEED + 12),
                                               batch, crop))
    first = {}
    for amp in (False, True):
        model = init_model(cfg, device='cuda',
                           generator=torch.Generator().manual_seed(SEED + 12))
        opt, sched = build_optimizer(model, cfg.optim_wrapper,
                                     cfg.param_scheduler)
        step = make_train_step(model, opt, model.data_preprocessor, amp=amp)
        state = create_train_state(model, opt, sched)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        times = []
        for i in range(1 + TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, logs = step(state, imgs, lbl)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            vals = {k: v.item() for k, v in logs.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f'bf16 {amp} step {state.step}: {vals}')
            if i == 0:
                first[amp] = vals['loss']
        dtypes = {p.dtype for p in model.parameters()} | \
            {p.grad.dtype for p in model.parameters()}
        if dtypes != {torch.float32}:
            raise AssertionError(f'master weights or gradients in {dtypes}')
        ms = sum(times[1:]) / TRAIN_STEPS
        say(f'  BiSeNetV2 {"bfloat16 (amp)" if amp else "float32"} train step, '
            f'bs {batch} at {crop[0]}x{crop[1]} (TF32 off): {ms:.3f} ms/step '
            f'({batch * 1000 / ms:.2f} img/s) over {TRAIN_STEPS} steps after '
            f'the first, dropout 0; peak memory allocated '
            f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, of it '
            f'{held / 2**30:.3f} GiB before the first step; first loss '
            f'{first[amp]:.6f}; master weights and gradients float32; on {card}')
        del model, opt, step, state, logs
        torch.cuda.empty_cache()
    diff = abs(first[True] - first[False])
    say(f'  BiSeNetV2 bfloat16 vs float32 first loss: |diff| {diff:.3e} '
        f'(bound 2^-8 x |loss| = {BF16_U * abs(first[False]):.3e})')
    if not (0 < diff <= BF16_U * abs(first[False])):
        raise AssertionError('the bfloat16 loss is not within bfloat16 '
                             'rounding of the float32 loss, or equals it')


def bise_hrnet(card, tmp):
    """Phase 12 on the tree of :func:`zoo_tree` in ``tmp``: ``init_model``
    on the card of every BiSeNetV2 config and every HRNet config on
    Cityscapes (BISE_HRNET_CONFIGS), BiSeNetV2 and HRNet through
    :func:`zoo_models`, the bfloat16 step, then the ``-amp-`` config and
    HRNet-W18 through the CLIs; returns what ``zoo_models`` does."""
    import glob
    from lednet_tpu_torch.apis import init_model
    configs = sorted(c for pattern in BISE_HRNET_CONFIGS
                     for c in glob.glob(pattern))
    t0 = time.perf_counter()
    sizes = {}
    for config in configs:
        model = init_model(config, device='cuda')
        sizes[os.path.basename(config)] = sum(p.numel()
                                              for p in model.parameters())
        del model
    say(f'  init_model on the card, {len(configs)} configs in '
        f'{time.perf_counter() - t0:.2f} s; parameters: ' +
        ', '.join(f'{k} {v}' for k, v in sizes.items()))
    if len(configs) != 14:
        raise AssertionError(f'{len(configs)} configs, not 4 + 10')
    out = zoo_models(card, BISE_HRNET, BISE_HRNET_WIDE)
    bf16_step(card)
    zoo_entry_points(card, tmp, 'BiSeNetV2 (bf16)', BISE_AMP)
    zoo_entry_points(card, tmp, *BISE_HRNET[1])
    return out


def compose_base(directory, entry):
    """Write the config of a VIT_FPN or CONTEXT_HEADS ``entry`` into
    ``directory`` and return
    its path: the ``_base_`` model file with its dataset file,
    ``default_runtime.py`` and its schedule (absolute paths into this
    checkout's ``configs/_base_``), the preprocessor's ``size`` set to the
    crop, and every head's ``num_classes`` to the dataset's (the MLN
    UPerNet's file says 19).  Both packages read the file."""
    from lednet_tpu_torch.config import Config
    _, model_file, dataset, schedule, classes, crop = entry
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'configs',
                        '_base_')
    model_path = os.path.join(base, 'models', model_file)
    model = Config.fromfile(model_path).model

    def heads(cfg):
        if isinstance(cfg, (list, tuple)):        # replaced whole: a list
            return [dict(h, num_classes=classes) for h in cfg]
        return dict(num_classes=classes)          # merged into the file's
    fields = [f'decode_head={heads(model.decode_head)!r}']
    if model.get('auxiliary_head'):
        fields.append(f'auxiliary_head={heads(model.auxiliary_head)!r}')
    text = '\n'.join([
        '_base_ = ' + repr([model_path, os.path.join(base, 'datasets', dataset),
                            os.path.join(base, 'default_runtime.py'),
                            os.path.join(base, 'schedules', schedule)]),
        f'crop_size = {tuple(crop)!r}',
        'data_preprocessor = dict(size=crop_size)',
        'model = dict(data_preprocessor=data_preprocessor, '
        + ', '.join(fields) + ')', ''])
    path = os.path.join(directory, model_file.replace('.py', '_composed.py'))
    with open(path, 'w') as f:
        f.write(text)
    return path


@contextlib.contextmanager
def zoo_tree():
    """The fabricated Cityscapes tree of phases 10-12
    (``ZOO_TREE_TRAIN`` + ``ZOO_TREE_VAL`` 2048x1024 frames) in a temporary
    directory, removed after: yields that directory, the tree being its
    ``cityscapes``."""
    import shutil
    import tempfile
    from lednet_tpu_torch.datasets.synthetic import make_cityscapes_tree
    tmp = tempfile.mkdtemp(prefix='lednet_zoo_')
    try:
        t0 = time.perf_counter()
        make_cityscapes_tree(os.path.join(tmp, 'cityscapes'),
                             n_train=ZOO_TREE_TRAIN, n_val=ZOO_TREE_VAL,
                             size_hw=FRAME_HW, seed=SEED + 10)
        say(f'  fabricated {ZOO_TREE_TRAIN} train and {ZOO_TREE_VAL} val '
            f'frames at {FRAME_HW[1]}x{FRAME_HW[0]} in '
            f'{time.perf_counter() - t0:.2f} s')
        yield tmp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def data_root_options(cfg, data):
    """``--cfg-options`` that point every loader of ``cfg`` at ``data``,
    through the dataset wrappers: a ``ConcatDataset``'s children go as one
    list literal (the options take no list index), a ``RepeatDataset``'s
    inner dataset by its key."""
    from lednet_tpu_torch.datasets import configure_datasets
    options = []
    for key in ('train_dataloader', 'val_dataloader', 'test_dataloader'):
        ds = cfg[key]['dataset']
        if 'datasets' in ds:
            children = json.loads(json.dumps(
                configure_datasets(ds, data_root=data)['datasets']))
            options.append(f'{key}.dataset.datasets={children!r}')
        elif 'dataset' in ds:
            options.append(f'{key}.dataset.dataset.data_root={data}')
        else:
            options.append(f'{key}.dataset.data_root={data}')
    return options


def zoo_entry_points(card, tmp, label, config, tree='cityscapes', tta=None,
                     test=True, options=()):
    """Phases 10-15, entry points, called in this process (:func:`call_cli`):
    ``config`` through the train CLI (``ZOO_ITERS`` steps, one val at the
    end) on the tree ``tree`` in
    ``tmp`` (phases 10-12: :func:`zoo_tree`'s Cityscapes tree; phase 13:
    an ADE20K one; phase 14: DRIVE and Pascal Context ones; phase 15: VOC
    aug, COCO-Stuff and iSAID ones), then, with ``test``, the test CLI on
    the last checkpoint, which must equal that val; with ``tta`` (a
    ``tta_pipeline``) the test CLI once more with ``--tta`` and that
    pipeline, whose metrics must be finite.  ``options`` are more
    ``--cfg-options`` of both CLIs."""
    from lednet_tpu_torch.config import Config

    cfg = Config.fromfile(config)
    crop = loader_crop(cfg)
    loader = cfg.train_dataloader
    options = data_root_options(cfg, os.path.join(tmp, tree)) + list(options)
    work = os.path.join(tmp, 'work_' + label.replace(' ', '_'))
    t0 = time.perf_counter()
    iters, vals = train_log(call_cli(
        ['tools/torch_port_train.py', config, '--work-dir', work,
         '--cfg-options', *options, f'train_cfg.max_iters={ZOO_ITERS}',
         f'train_cfg.val_interval={ZOO_ITERS}',
         f'default_hooks.checkpoint.interval={ZOO_ITERS}',
         'default_hooks.logger.interval=5']))
    say(f'  {label} train CLI, {ZOO_ITERS} steps: '
        f'{time.perf_counter() - t0:.2f} s; loss at ' +
        ', '.join(f'{k}: {v[0]:.4f}' for k, v in iters.items()) +
        f'; val at {sorted(vals)}: {vals.get(ZOO_ITERS)}')
    if sorted(iters) != list(range(5, ZOO_ITERS + 1, 5)) or not all(
            np.isfinite(v[0]) for v in iters.values()) or \
            sorted(vals) != [ZOO_ITERS]:
        raise AssertionError(f'train log {iters}, val at {sorted(vals)}')
    steady = [iters[k] for k in iters if k > 5]
    it_s = sum(v[1] for v in steady) / len(steady)
    wait_s = sum(v[2] for v in steady) / len(steady)
    say(f'  {label} train iteration (the CLI\'s log, steps 6-{ZOO_ITERS}, '
        f'bs {loader.batch_size} of {crop[0]}x{crop[1]} crops, '
        f'{loader.get("num_workers", 2)} loader threads): '
        f'{it_s * 1e3:.1f} ms; on {card}')
    say(f'  {label} of it waiting on the loader: {wait_s * 1e3:.1f} ms; '
        f'on {card}')
    checkpoint = os.path.join(work, f'iter_{ZOO_ITERS}.pth')
    if test:
        t0 = time.perf_counter()
        lines = call_cli(['tools/torch_port_test.py', config, checkpoint,
                         '--work-dir', os.path.join(work, 'test'),
                         '--cfg-options', *options])
        tested = json.loads(lines[-1])
        say(f'  {label} test CLI on iter_{ZOO_ITERS}.pth: '
            f'{time.perf_counter() - t0:.2f} s; {tested} (val at step '
            f'{ZOO_ITERS}: {vals[ZOO_ITERS]})')
        if tested != vals[ZOO_ITERS]:
            raise AssertionError(f'the test CLI does not reproduce the val at '
                                 f'step {ZOO_ITERS}')
    if tta is not None:
        t0 = time.perf_counter()
        lines = call_cli(['tools/torch_port_test.py', config, checkpoint,
                         '--tta', '--work-dir', os.path.join(work, 'test_tta'),
                         '--cfg-options', *options, f'tta_pipeline={tta!r}'])
        tested = json.loads(lines[-1])
        say(f'  {label} test CLI --tta on iter_{ZOO_ITERS}.pth: '
            f'{time.perf_counter() - t0:.2f} s; {tested}')
        if not tested or not all(np.isfinite(v) for v in tested.values()):
            raise AssertionError(f'test-time augmentation gave {tested}')


def segnext(card, tmp):
    """Phase 13: ``init_model`` on the card of every SegNeXt config
    (SEGNEXT_CONFIGS) with its parameter count, SegNeXt-T through
    :func:`zoo_models` (S, B and L once each), then T through the CLIs on a
    fabricated ADE20K tree in ``tmp``; returns what ``zoo_models`` does."""
    import glob
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.datasets.synthetic import make_ade20k_tree
    configs = sorted(c for pattern in SEGNEXT_CONFIGS for c in glob.glob(pattern))
    t0 = time.perf_counter()
    sizes = {}
    for config in configs:
        model = init_model(config, device='cuda')
        sizes[os.path.basename(config)] = sum(p.numel()
                                              for p in model.parameters())
        del model
    say(f'  init_model on the card, {len(configs)} configs in '
        f'{time.perf_counter() - t0:.2f} s; parameters: ' +
        ', '.join(f'{k} {v}' for k, v in sizes.items()))
    if len(configs) != 4:
        raise AssertionError(f'{len(configs)} SegNeXt configs, not 4')
    out = zoo_models(card, SEGNEXT, SEGNEXT_WIDE)
    t0 = time.perf_counter()
    make_ade20k_tree(os.path.join(tmp, 'ade'), n_train=ADE_TREE_TRAIN,
                     n_val=ADE_TREE_VAL, sizes_hw=ADE_FRAMES_HW, seed=SEED + 13)
    say(f'  fabricated {ADE_TREE_TRAIN} train and {ADE_TREE_VAL} val ADE20K '
        f'frames at {ADE_FRAMES_HW} (h, w) in {time.perf_counter() - t0:.2f} s')
    zoo_entry_points(card, tmp, *SEGNEXT[0], tree='ade')
    return out


def slide(card, tmp):
    """Phase 14: ``init_model`` on the card of every slide config
    (SLIDE_CONFIGS: UNet-S5-D16 on DRIVE, the twelve HRNet Pascal Context
    configs) with its parameter count; UNet through :func:`zoo_models` on
    DRIVE_FRAME_HW frames (584x565 padded to 608x576 by ``inference_model``:
    196 crops of 64x64 per forward); HRNet-W18 on Pascal Context-59, one
    replayed slide forward on a PASCAL_SQUARE_HW frame against eager (2 x 2
    crops of 480), and ``inference_model`` on a PASCAL_FRAME_HW photo, which
    must raise as the JAX package does (resized to 390x520 and padded to
    416x544, fewer rows than the crop); then UNet through the CLIs on a
    fabricated DRIVE tree (the test CLI plain, held to the val, and with
    ``--tta``, by the ``tta_pipeline`` of ``configs/_base_/datasets/drive.py``,
    which the UNet config does not carry) and HRNet-W18 on a fabricated Pascal Context
    tree (no ``--tta``: its 0.5 view is smaller than the crop and raises, as
    in the JAX package); returns what ``zoo_models`` does."""
    import glob
    import torch
    from lednet_tpu_torch.apis import inference_model, init_model
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.datasets.synthetic import (make_drive_tree,
                                                     make_pascal_context_tree)
    configs = sorted(c for pattern in SLIDE_CONFIGS for c in glob.glob(pattern))
    t0 = time.perf_counter()
    sizes = {}
    for config in configs:
        model = init_model(config, device='cuda')
        if model.test_cfg.get('mode') != 'slide':
            raise AssertionError(f'{config}: test_cfg {model.test_cfg}')
        sizes[os.path.basename(config)] = sum(p.numel()
                                              for p in model.parameters())
        del model
    say(f'  init_model on the card, {len(configs)} configs in '
        f'{time.perf_counter() - t0:.2f} s; parameters: ' +
        ', '.join(f'{k} {v}' for k, v in sizes.items()))
    if len(configs) != 13:
        raise AssertionError(f'{len(configs)} slide configs, not 1 + 12')
    out = zoo_models(card, SLIDE, (), frame_hw=DRIVE_FRAME_HW,
                     check=SLIDE_CHECK)

    label, config = PASCAL_HR18
    gen = torch.Generator().manual_seed(SEED + 14)
    rng = np.random.default_rng(SEED + 14)
    square = torch.from_numpy(rng.integers(0, 256, (1,) + PASCAL_SQUARE_HW + (3,),
                                           dtype=np.uint8)).cuda()
    once(card, label, config, square, gen)
    timed_train(card, label, Config.fromfile(config), rng, gen)
    model = init_model(config, device='cuda', generator=gen)
    photo = rng.integers(0, 256, PASCAL_FRAME_HW + (3,), dtype=np.uint8)
    try:
        inference_model(model, photo)
    except ValueError as e:
        say(f'  {label} inference_model on a {PASCAL_FRAME_HW[1]}x'
            f'{PASCAL_FRAME_HW[0]} photo raises, as in the JAX package: {e}')
    else:
        raise AssertionError(f'{label}: a crop larger than the padded image '
                             'did not raise')
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    make_drive_tree(os.path.join(tmp, 'drive'), n_train=DRIVE_TREE_TRAIN,
                    n_val=DRIVE_TREE_VAL, size_hw=DRIVE_FRAME_HW, seed=SEED + 14)
    make_pascal_context_tree(os.path.join(tmp, 'pascal'),
                             n_train=PASCAL_TREE_TRAIN, n_val=PASCAL_TREE_VAL,
                             seed=SEED + 14)
    say(f'  fabricated {DRIVE_TREE_TRAIN} + {DRIVE_TREE_VAL} DRIVE frames at '
        f'{DRIVE_FRAME_HW} (h, w) and {PASCAL_TREE_TRAIN} + {PASCAL_TREE_VAL} '
        f'Pascal Context photos in {time.perf_counter() - t0:.2f} s')
    # plain lists and dicts, which the CLI's --cfg-options parse back
    tta = json.loads(json.dumps(
        Config.fromfile('configs/_base_/datasets/drive.py').tta_pipeline))
    zoo_entry_points(card, tmp, *SLIDE[0], tree='drive', tta=tta)
    zoo_entry_points(card, tmp, label, config, tree='pascal')
    return out


def datasets(card, tmp):
    """Phase 15: ``init_model`` on the card of every config that the VOC +
    SBD aug, COCO-Stuff 164k, iSAID, LoveDA, Potsdam and Vaihingen
    datasets unblock (DATASET_CONFIGS: HRNet-W18/W18-Small/W48 on the
    first five and BiSeNetV1 R-18/R-50/R-101 on COCO-Stuff, each also
    ``-in1k-pre``) with its parameter count; BiSeNetV1 R-50 through
    :func:`zoo_models` (R-101 once); then, on fabricated trees in ``tmp``,
    HRNet-W18 on VOC aug (a ``ConcatDataset`` of the train and aug lists,
    ``Pad`` to 512x512) and BiSeNetV1 R-50 on COCO-Stuff through the train
    and test CLIs, and HRNet-W18-Small on iSAID (896x896 crops) through
    the train CLI; returns what ``zoo_models`` does."""
    import glob
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.datasets import synthetic
    configs = sorted(c for pattern in DATASET_CONFIGS for c in glob.glob(pattern))
    t0 = time.perf_counter()
    sizes = {}
    for config in configs:
        model = init_model(config, device='cuda')
        sizes[os.path.basename(config)] = sum(p.numel()
                                              for p in model.parameters())
        del model
    say(f'  init_model on the card, {len(configs)} configs in '
        f'{time.perf_counter() - t0:.2f} s; parameters: ' +
        ', '.join(f'{k} {v}' for k, v in sizes.items()))
    if len(configs) != 24:
        raise AssertionError(f'{len(configs)} configs, not 18 + 6')
    out = zoo_models(card, BISENET_R50, BISENET_R101)
    t0 = time.perf_counter()
    synthetic.make_voc_aug_tree(
        os.path.join(tmp, 'voc'), n_train=VOC_TREE_TRAIN, n_aug=VOC_TREE_AUG,
        n_val=VOC_TREE_VAL, sizes_hw=VOC_FRAMES_HW, seed=SEED + 15)
    synthetic.make_coco_stuff_tree(
        os.path.join(tmp, 'coco'), n_train=COCO_TREE_TRAIN, n_val=COCO_TREE_VAL,
        size_hw=COCO_FRAME_HW, seed=SEED + 15)
    synthetic.make_isaid_tree(
        os.path.join(tmp, 'isaid'), n_train=ISAID_TREE_TRAIN,
        n_val=ISAID_TREE_VAL, size_hw=ISAID_TILE_HW, seed=SEED + 15)
    say(f'  fabricated VOC aug ({VOC_TREE_TRAIN} train + {VOC_TREE_AUG} aug + '
        f'{VOC_TREE_VAL} val PNGs at {VOC_FRAMES_HW}), COCO-Stuff '
        f'({COCO_TREE_TRAIN} + {COCO_TREE_VAL} JPEGs at {COCO_FRAME_HW}) and '
        f'iSAID ({ISAID_TREE_TRAIN} + {ISAID_TREE_VAL} PNG tiles at '
        f'{ISAID_TILE_HW}) in {time.perf_counter() - t0:.2f} s')
    zoo_entry_points(card, tmp, *VOC_HR18, tree='voc')
    zoo_entry_points(card, tmp, *BISENET_R50[0], tree='coco')
    zoo_entry_points(card, tmp, *ISAID_HR18S, tree='isaid', test=False)
    return out


def realtime(card, tmp):
    """Phase 16: the five of REALTIME (ICNet R-18 with its neck, Fast-SCNN,
    ERFNet, CGNet, LR-ASPP MobileNetV3-L) through :func:`zoo_models` on
    the Cityscapes test frame (1 x 1024 x 2048), each also against its copy
    on the CPU at CPU_FRAME_HW, its train step against the CPU's at
    REALTIME_CHECK, then ICNet and CGNet through the CLIs on
    :func:`zoo_tree`'s tree in ``tmp``; returns what ``zoo_models``
    does."""
    out = zoo_models(card, REALTIME, (), frame_hw=FRAME_HW, cpu_hw=CPU_FRAME_HW,
                     check=REALTIME_CHECK)
    for label, config in REALTIME:
        if label in REALTIME_CLIS:
            zoo_entry_points(card, tmp, label, config)
    return out


def dsnet_module(card):
    """Phase 17's DSNet-S (DSNET_CONFIG), the module the JAX package runs
    (it has no ``loss`` and no ``predict``): ``init_model`` on its config
    must raise; built by ``MODELS.build`` on the card with seeded weights
    and non-trivial BatchNorm stats, its eval forward on a seeded
    normalized 1 x 3 x 1024 x 2048 frame (no preprocessor: it launches no
    kernel of the port, counted in the wrappers and on the device) gives
    three finite (1, 19, 1024, 2048) maps; on a CPU_FRAME_HW frame each of
    the three against the module copied to the CPU within TOL_MODEL x its
    max and argmax agreement >= MIN_ARGMAX_AGREEMENT; eager time over 50
    calls after 5 and peak memory."""
    import torch
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.models.layers import init_weights
    from lednet_tpu_torch.ops import kernels
    from lednet_tpu_torch.registry import MODELS
    cfg = Config.fromfile(DSNET_CONFIG)
    try:
        init_model(cfg, device='cuda')
    except TypeError as e:
        say(f'  DSNet-S: init_model raises, as the JAX package\'s does: {e}')
    else:
        raise AssertionError('init_model built DSNet-S as a segmentor')
    gen = torch.Generator().manual_seed(SEED + 17)
    model = MODELS.build(dict(cfg.model))
    init_weights(model, gen)
    randomize_norms(model, gen)
    model = model.cuda().eval()
    classes = cfg.model.num_classes
    x = torch.randn((1, 3) + FRAME_HW, generator=gen).cuda()
    # an EmptyTrace is the profiler's failure (see traced_forward): the
    # forward is traced once more
    for attempt in (0, 1):
        kernels.reset_launch_counts()
        traced = {}
        try:
            with torch.inference_mode():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                with device_trace(traced):
                    outs = model(x)
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            break
        except EmptyTrace:
            if attempt:
                raise
            say('  the device trace recorded no kernel at all; tracing the '
                'DSNet forward again')
    counts = kernels.launch_counts()
    say(f'  DSNet-S module forward 1x3x{FRAME_HW[0]}x{FRAME_HW[1]}: wrapper '
        f'launches {counts}; CUDA launches on the device {traced}')
    if any(counts.values()) or any(traced.values()):
        raise AssertionError('the DSNet forward launched a kernel of the port')
    if len(outs) != 3 or any(o.shape != (1, classes) + FRAME_HW or
                             not torch.isfinite(o).all() for o in outs):
        raise AssertionError(f'DSNet outputs {[tuple(o.shape) for o in outs]}')
    with torch.inference_mode():
        eager_ms = cuda_ms(lambda: model(x), reps=ZOO_TIMED, warmup=2)
    say(f'  DSNet-S module forward 1x3x{FRAME_HW[0]}x{FRAME_HW[1]} (aux_p, '
        f'main, aux_d): eager {eager_ms:.3f} ms ({1000 / eager_ms:.1f} '
        f'img/s); peak memory above what was held {peak:.3f} GiB; on {card}')
    small = torch.randn((1, 3) + CPU_FRAME_HW, generator=gen)
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        want = [o.double() for o in cpu_model(small)]
        got = [o.cpu().double() for o in model(small.cuda())]
    for name, a, b in zip(('aux_p', 'main', 'aux_d'), got, want):
        e = ((a - b).abs().max() / b.abs().max()).item()
        agree = (a.argmax(1) == b.argmax(1)).double().mean().item()
        say(f'  DSNet-S {name} 1x3x{CPU_FRAME_HW[0]}x{CPU_FRAME_HW[1]}: the '
            f'card vs the module copied to the CPU rel {e:.3e} (tol '
            f'{TOL_MODEL:g}), argmax agreement {agree:.6f}')
        if not (e <= TOL_MODEL and agree >= MIN_ARGMAX_AGREEMENT):
            raise AssertionError(f'DSNet {name}: the card and the CPU disagree')
    del model, cpu_model, outs, x
    torch.cuda.empty_cache()


def sct_rtformer_psp(card, tmp):
    """Phase 17: the four of SCT_RTF_PSP through :func:`zoo_models` on the
    Cityscapes test frame (1 x 1024 x 2048), RTFormer-Slim once, each also
    against its copy on the CPU at CPU_FRAME_HW and its train step against
    the CPU's at REALTIME_CHECK (SCT_RTF) or R50_D8_CHECK (R50_D8);
    DSNet-S as a module (:func:`dsnet_module`);
    then RTFormer-Base and DeepLabV3+ through the CLIs on
    :func:`zoo_tree`'s tree in ``tmp``; returns what ``zoo_models`` does."""
    launches, device, a_err = zoo_models(
        card, SCT_RTF, SCT_RTF_PSP_WIDE, frame_hw=FRAME_HW,
        cpu_hw=CPU_FRAME_HW, check=REALTIME_CHECK)
    more = zoo_models(card, R50_D8, (), frame_hw=FRAME_HW, cpu_hw=CPU_FRAME_HW,
                      check=R50_D8_CHECK)
    launches = {n: c + more[0][n] for n, c in launches.items()}
    device = {n: c + more[1][n] for n, c in device.items()}
    dsnet_module(card)
    for label, config in SCT_RTF_PSP:
        if label in SCT_RTF_PSP_CLIS:
            zoo_entry_points(card, tmp, label, config)
    return launches, device, max(a_err, more[2])


def cascade_transformers(card, tmp):
    """Phase 18: OCRNet HR18, PointRend R50 and SegFormer-B0 (CASCADE_MIT)
    through :func:`zoo_models` on the Cityscapes test frame (1 x 1024 x
    2048), each also against its copy on the CPU at CPU_FRAME_HW, and
    UPerNet Swin-T (SWIN) on an ADE20K test frame of ADE_TEST_HW, against
    its CPU copy at SWIN_CPU_HW; each train step against the CPU's at
    PHASE18_CHECK (PointRend's point selection pinned in float32 with the
    other decisions); then OCRNet through the CLIs on :func:`zoo_tree`'s
    tree in ``tmp`` (the cascade through ``Runner.val``) and Swin-T on
    phase 13's ADE20K tree (made here where phase 13 did not run); returns
    what ``zoo_models`` does."""
    from lednet_tpu_torch.datasets.synthetic import make_ade20k_tree
    launches, device, a_err = zoo_models(
        card, CASCADE_MIT, (), frame_hw=FRAME_HW, cpu_hw=CPU_FRAME_HW,
        check=PHASE18_CHECK)
    more = zoo_models(card, SWIN, (), frame_hw=ADE_TEST_HW, cpu_hw=SWIN_CPU_HW,
                      check=PHASE18_CHECK)
    launches = {n: c + more[0][n] for n, c in launches.items()}
    device = {n: c + more[1][n] for n, c in device.items()}
    zoo_entry_points(card, tmp, *CASCADE_MIT[0])
    if not os.path.isdir(os.path.join(tmp, 'ade')):
        make_ade20k_tree(os.path.join(tmp, 'ade'), n_train=ADE_TREE_TRAIN,
                         n_val=ADE_TREE_VAL, sizes_hw=ADE_FRAMES_HW,
                         seed=SEED + 13)
    zoo_entry_points(card, tmp, *SWIN[0], tree='ade')
    return launches, device, max(a_err, more[2])


def knet_mask2former(card, tmp):
    """Phase 19: K-Net s3 R50-D8 and Mask2Former R50 (KNET_M2F) through
    :func:`zoo_models` on the Cityscapes test frame (1 x 1024 x 2048),
    each also against its copy on the CPU at CPU_FRAME_HW, each train step
    against the CPU's at PHASE19_CHECK (K-Net's hard masks, Mask2Former's
    attention masks, its Hungarian assignment and its loss's points pinned
    in float32 with the other decisions); one Mask2Former forward with the
    deformable pixel decoder (MSDEFORM), replayed and eager and against
    its CPU copy; then both through the CLIs on :func:`zoo_tree`'s tree in
    ``tmp``; returns what ``zoo_models`` does."""
    import torch
    from lednet_tpu_torch.config import Config
    out = zoo_models(card, KNET_M2F, (), frame_hw=FRAME_HW, cpu_hw=CPU_FRAME_HW,
                     check=PHASE19_CHECK)
    rng = np.random.default_rng(SEED + 19)
    x8 = torch.from_numpy(rng.integers(0, 256, (1,) + FRAME_HW + (3,),
                                       dtype=np.uint8)).cuda()
    small = torch.from_numpy(rng.integers(0, 256, (1,) + CPU_FRAME_HW + (3,),
                                          dtype=np.uint8))
    cfg = Config.fromfile(KNET_M2F[1][1])
    cfg.merge_from_dict(MSDEFORM)
    once(card, 'Mask2Former R50 msdeform', cfg, x8, torch.Generator().manual_seed(
        SEED + 19), cpu_x8=small)
    for label, config in KNET_M2F:
        zoo_entry_points(card, tmp, label, config)
    return out


def san(card, tmp):
    """Phase 20: SAN ViT-B16 (SAN, with SAN_OPTIONS) through
    :func:`zoo_models` on the Cityscapes test frame (1 x 1024 x 2048): its
    train step at the config's batch of the loader's crops with the host
    time of each Hungarian matching, the card's step against the CPU's at
    PHASE20_CHECK with one template (SAN_SIMPLE; in float32 the assignment
    and the loss's points pinned with the ReLU signs); the text tower's
    share of the forward's device time; the eval step at CPU_FRAME_HW with
    one template against its CPU copy; the train and test CLIs on
    :func:`zoo_tree`'s tree in ``tmp``; the config as shipped raising.
    Returns what ``zoo_models`` does."""
    import torch
    from lednet_tpu_torch.apis import init_model
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.engine import float32_math, make_eval_step
    from lednet_tpu_torch.models.decode_heads.san_head import SideAdapterCLIPHead
    label, config = SAN[0]
    try:
        init_model(config, device='cuda')
    except ValueError as e:
        say(f'  {label} as shipped (no out_origin) raises ValueError: {e}')
    else:
        raise AssertionError(f'{label} as shipped built')

    # the matching's host time in the timed train steps: the wait for the
    # cost on the card (the forward's queue) and scipy's Hungarian
    batch = Config.fromfile(config).train_dataloader.batch_size
    matching, assign = [], SideAdapterCLIPHead.assign

    def timed_assign(self, cost):
        t0 = time.perf_counter()
        host = cost.detach().cpu()
        t1 = time.perf_counter()
        out = assign(self, host).to(cost.device)
        if cost.is_cuda and cost.shape[0] == batch:
            matching.append((t1 - t0, time.perf_counter() - t1))
        return out
    SideAdapterCLIPHead.assign = timed_assign
    try:
        out = zoo_models(card, tuple((*m, SAN_OPTIONS) for m in SAN), (),
                         frame_hw=FRAME_HW, check=PHASE20_CHECK,
                         check_options=SAN_SIMPLE)
    finally:
        SideAdapterCLIPHead.assign = assign
    matching = matching[2:]          # the warm-up step's two, scipy's import
    if not matching:
        raise AssertionError('no matching was timed')
    wait, scipy_s = (np.array(v) * 1e3 for v in zip(*matching))
    say(f'  {label} train step matching ({len(matching)} calls of the timed '
        f'steps, 2 a step: the deep-supervision tap and the last): waiting '
        f'for the cost on '
        f'the card {np.median(wait):.3f} ms (median; {wait.min():.3f}-'
        f'{wait.max():.3f}), scipy\'s Hungarian on {batch} images '
        f'{np.median(scipy_s):.3f} ms ({scipy_s.min():.3f}-{scipy_s.max():.3f})'
        f'; host clock; on {card}')

    # the text tower's share of the forward (CUDA events, float32)
    gen = torch.Generator().manual_seed(SEED + 20)
    rng = np.random.default_rng(SEED + 20)
    model = init_model(config, device='cuda', generator=gen,
                       cfg_options=SAN_OPTIONS)
    randomize_norms(model, gen)
    step = make_eval_step(model, model.data_preprocessor)
    x8 = torch.from_numpy(rng.integers(0, 256, (1,) + FRAME_HW + (3,),
                                       dtype=np.uint8)).cuda()
    with torch.inference_mode(), float32_math():
        text_ms = cuda_ms(model.text_encoder, reps=ZOO_TIMED, warmup=2)
        replay_ms = cuda_ms(lambda: step(x8), reps=ZOO_TIMED, warmup=2)
    prompts = model.text_encoder.tokens.shape[0]
    say(f'  {label} text tower ({prompts} prompts of 77 tokens, eager): '
        f'{text_ms:.3f} ms, {text_ms / replay_ms:.3f} of the replayed '
        f'forward\'s {replay_ms:.3f} ms at 1x{FRAME_HW[0]}x{FRAME_HW[1]} '
        f'(CUDA events, float32); on {card}')
    del model, step
    torch.cuda.empty_cache()

    # the card against its CPU copy, one template
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(dict(SAN_OPTIONS, **SAN_SIMPLE))
    small = torch.from_numpy(rng.integers(0, 256, (1,) + CPU_FRAME_HW + (3,),
                                          dtype=np.uint8))
    once(card, f'{label} one template', cfg, small.cuda(), gen, cpu_x8=small)
    zoo_entry_points(card, tmp, label, config,
                     options=[f'{k}={v!r}'.replace(' ', '')
                              for k, v in SAN_CLI_OPTIONS.items()])
    return out


def vit_fpn(card, tmp):
    """Phase 21: the eight VIT_FPN configs, composed into ``tmp``
    (:func:`compose_base`), through :func:`zoo_models` at full width: SETR
    naive, PUP and MLA (ViT-L), FPN R50 and PointRend-FPN R50 on the
    Cityscapes test frame (1 x 1024 x 2048), Segmenter (slide), DPT and the
    MLN UPerNet (ViT-B) on an ADE20K test frame of ADE_TEST_HW; each
    against its copy on the CPU at CPU_FRAME_HW (Segmenter at ADE_TEST_HW:
    its 512 crops do not fit the smaller frame), each train step at the
    composed config's batch and crop with its drop rates active; the
    card's step against the CPU's (the rates 0, :func:`without_dropout`)
    for SETR-MLA at SETR_MLA_CHECK, Segmenter and DPT at VIT_B_CHECK and
    PointRend-FPN at PHASE21_CHECK; then SETR-MLA (val one frame a chunk)
    and PointRend-FPN through the CLIs on :func:`zoo_tree`'s tree in
    ``tmp`` and Segmenter (slide val) on phase 13's ADE20K tree (made here
    where no earlier phase made it).  Returns what ``zoo_models`` does,
    summed."""
    from lednet_tpu_torch.datasets.synthetic import make_ade20k_tree
    configs = {e[0]: compose_base(tmp, e) for e in VIT_FPN}

    def models(*labels):
        return tuple((label, configs[label]) for label in labels)
    runs = [
        (models('SETR MLA'), FRAME_HW, CPU_FRAME_HW, SETR_MLA_CHECK),
        (models('PointRend-FPN R50'), FRAME_HW, CPU_FRAME_HW, PHASE21_CHECK),
        (models('SETR naive', 'SETR PUP', 'FPN R50'), FRAME_HW, CPU_FRAME_HW,
         None),
        (models('Segmenter ViT-B'), ADE_TEST_HW, ADE_TEST_HW, VIT_B_CHECK),
        (models('DPT ViT-B'), ADE_TEST_HW, CPU_FRAME_HW, VIT_B_CHECK),
        (models('UPerNet ViT-B MLN'), ADE_TEST_HW, CPU_FRAME_HW, None)]
    launches, device, a_err = {}, {}, 0.0
    for group, frame_hw, cpu_hw, check in runs:
        more = zoo_models(card, group, (), frame_hw=frame_hw, cpu_hw=cpu_hw,
                          check=check)
        launches = {n: launches.get(n, 0) + c for n, c in more[0].items()}
        device = {n: device.get(n, 0) + c for n, c in more[1].items()}
        a_err = max(a_err, more[2])
    # the Runner's val stacks 8 frames a chunk: ViT-L's scores at 8 x
    # 9,793 tokens (a 1025x2050 frame padded to 1152x2176) would take 49
    # GB a layer, twice over with the softmax's output; one frame a chunk
    zoo_entry_points(card, tmp, 'SETR MLA', configs['SETR MLA'],
                     options=['val_batch_size=1'])
    zoo_entry_points(card, tmp, 'PointRend-FPN R50', configs['PointRend-FPN R50'])
    if not os.path.isdir(os.path.join(tmp, 'ade')):
        make_ade20k_tree(os.path.join(tmp, 'ade'), n_train=ADE_TREE_TRAIN,
                         n_val=ADE_TREE_VAL, sizes_hw=ADE_FRAMES_HW,
                         seed=SEED + 13)
    zoo_entry_points(card, tmp, 'Segmenter ViT-B', configs['Segmenter ViT-B'],
                     tree='ade')
    return launches, device, a_err


def nl_heads(card):
    """Phase 22's NLHead and DNLHead: each file's ``decode_head`` (which
    passes ``mode``) raising ``TypeError``, then the head built without
    ``mode`` (seeded weights, non-trivial BatchNorm stats) on a seeded
    NL_FEATURE map, its forward on the card (eval, float32) against its
    copy on the CPU within TOL_MODEL with argmax agreement >=
    MIN_ARGMAX_AGREEMENT, timed (CUDA events)."""
    import torch
    import lednet_tpu_torch.models  # noqa: F401  (registers the modules)
    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.engine import float32_math
    from lednet_tpu_torch.models.layers import init_weights
    from lednet_tpu_torch.registry import MODELS
    gen = torch.Generator().manual_seed(SEED + 22)
    x = torch.randn(NL_FEATURE, generator=gen)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'configs',
                        '_base_', 'models')
    for head, name in NL_HEADS:
        cfg = dict(Config.fromfile(os.path.join(base, name)).model.decode_head)
        try:
            MODELS.build(cfg)
        except TypeError as e:
            say(f'  {name}\'s decode_head (mode={cfg["mode"]!r}) raises '
                f'TypeError: {e}')
        else:
            raise AssertionError(f'{head} took mode')
        cfg.pop('mode')
        cpu = MODELS.build(cfg)
        init_weights(cpu, gen)
        randomize_norms(cpu, gen)
        cpu.eval()
        module = copy.deepcopy(cpu).cuda()
        x_dev = x.cuda()
        with torch.inference_mode(), float32_math():
            want = cpu(x).double()
            got = module(x_dev).cpu().double()
            ms = cuda_ms(lambda: module(x_dev), reps=ZOO_TIMED, warmup=1)
        e = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(1) == want.argmax(1)).double().mean().item()
        say(f'  {head} (no mode) on {"x".join(map(str, NL_FEATURE))}: the '
            f'card vs its CPU copy rel {e:.3e} (tol {TOL_MODEL:g}), argmax '
            f'agreement {agree:.6f}; forward {ms:.3f} ms (float32, eager); '
            f'on {card}')
        if not (got.shape == want.shape and e <= TOL_MODEL
                and agree >= MIN_ARGMAX_AGREEMENT):
            raise AssertionError(f'{head}: the card and the CPU disagree')
        del module, x_dev
        torch.cuda.empty_cache()


def context_heads(card, tmp):
    """Phase 22: the ten CONTEXT_HEADS files, composed into ``tmp``
    (:func:`compose_base`), through :func:`zoo_models` at full width on the
    Cityscapes test frame (1 x 1024 x 2048), DANet's and CCNet's gammas
    seeded nonzero (:func:`seed_gammas`): each against its copy on the CPU
    at CPU_FRAME_HW, each train step at the composed config's batch and
    crop, the card's step against the CPU's at CONTEXT_CHECK for
    CONTEXT_CHECKED; then EMANet through the train and test CLIs on
    :func:`zoo_tree`'s tree in ``tmp`` (the test CLI equal to the val: the
    bases buffer goes through the checkpoint), and NLHead and DNLHead as
    heads (:func:`nl_heads`).  Returns what ``zoo_models`` does, summed."""
    configs = {e[0]: compose_base(tmp, e) for e in CONTEXT_HEADS}
    checked = tuple((label, configs[label]) for label in CONTEXT_CHECKED)
    rest = tuple((e[0], configs[e[0]]) for e in CONTEXT_HEADS
                 if e[0] not in CONTEXT_CHECKED)
    launches, device, a_err = {}, {}, 0.0
    for group, check in ((checked, CONTEXT_CHECK), (rest, None)):
        more = zoo_models(card, group, (), frame_hw=FRAME_HW,
                          cpu_hw=CPU_FRAME_HW, check=check)
        launches = {n: launches.get(n, 0) + c for n, c in more[0].items()}
        device = {n: device.get(n, 0) + c for n, c in more[1].items()}
        a_err = max(a_err, more[2])
    zoo_entry_points(card, tmp, 'EMANet R50-D8', configs['EMANet R50-D8'])
    nl_heads(card)
    return launches, device, a_err


# ---------------------------------------------------------------- phases
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    try:
        import lednet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here: {e}',
              file=sys.stderr)
        return 2
    from lednet_tpu_torch.apis import inference_model, init_model
    from lednet_tpu_torch.ops import kernels
    from lednet_tpu_torch.ops.kernels import _build, basic_pair, stem_convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    repo = os.path.dirname(os.path.abspath(__file__))
    os.chdir(repo)

    with phase('1 card'):
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0].strip()
        say(card)
        say(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
            f'device {torch.cuda.get_device_name(0)}, '
            f'count {torch.cuda.device_count()}')

    with phase('2 build'):
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.library()
        say(f'build {time.perf_counter() - t0:.2f} s -> '
            f'{os.path.relpath(lib_path, repo)}')
        log = (lib_path.parent / 'build.log').read_text().splitlines()
        for line in log[:1] + [l for l in log if 'registers' in l or 'spill' in l]:
            say('  ' + line.strip())

    gen = torch.Generator().manual_seed(SEED)
    with phase('3 kernels'):
        model = init_model(CONFIG, device='cuda', generator=gen)
        randomize_norms(model, gen)
        rng = np.random.default_rng(SEED)
        imgs = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
                for _ in range(N_IMAGES)]
        x_dev = torch.from_numpy(imgs[0][None]).cuda()
        calls, per_forward = traced_forward(model, x_dev)
        say(f'  CUDA launches of one forward (device trace): {per_forward}')
        errs = {name: [] for name in KERNEL_INFO}
        for name, op, args, kw in calls:
            tol = 0.0 if name == 'normalize_image' else TOL_KERNEL
            check_against_plain(name, op, args, kw, tol, errs[name])
        missing = [n for n, e in errs.items() if not e and n not in OFF_PATH]
        if missing:
            raise AssertionError(f'the main path called no {missing}')

    with phase('3b pyramid'):
        from lednet_tpu_torch.ops.kernels.sesp_pyramid import pyramid_geometry
        pyr_sets = pyramid_sets(calls, gen)
        traced = {}
        with device_trace(traced):
            for set_name, entries in pyr_sets.items():
                for name, op, args, kw in entries:
                    red, dw1, dw2, rates = args
                    B, n, H, W = red.shape
                    geo = pyramid_geometry(B, H, W, n, len(rates), tuple(rates),
                                           kw['stride'], dw2 is not None,
                                           red.data_ptr() % 16 == 0)
                    say(f'  [{set_name}] rates {tuple(rates)}, '
                        f'{"TMA" if geo.tma else "cp.async"}, tile '
                        f'{geo.th}x{geo.tw}, {geo.stages} stages, grid '
                        f'{geo.grid}, v2 {dw2 is not None}:')
                    check_against_plain(name, op, args, kw, TOL_KERNEL,
                                        errs[name])
        # the kernel launches once per check: the device function names the
        # later "E never launches" readings use do find its launches
        n_checks = sum(len(e) for e in pyr_sets.values())
        say(f'  {n_checks} checks, kernel E launches on the device: '
            f'{traced["sesp_pyramid"]}')
        if traced['sesp_pyramid'] < n_checks:
            # a profiler session can drop device records (see
            # traced_forward): the kernel launches are traced once more
            say('  tracing kernel E\'s launches again')
            traced = {}
            with device_trace(traced), torch.inference_mode():
                for entries in pyr_sets.values():
                    for _, op, args, kw in entries:
                        op(*args, **dict(kw, impl='cuda'))
            say(f'  kernel E launches on the device, traced again: '
                f'{traced["sesp_pyramid"]}')
        if traced['sesp_pyramid'] != n_checks:
            raise AssertionError(f'the trace shows {traced["sesp_pyramid"]} '
                                 f'launches of kernel E, not {n_checks}')
        if not any(a[0].shape[3] % 4 for _, _, a, _ in pyr_sets['ragged']):
            raise AssertionError('no ragged shape takes the cp.async path')
        pyr_calls = pyr_sets['flagship']

    with phase('3c ragged'):
        # kernels B and C called directly at shapes the main path never
        # gives them (it pads to /32): tile edges, batch 2, tiny maps
        ragged = []
        for shape, c in RAGGED_STEM:
            w1 = 0.3 * torch.randn((c, 3, 3, 3), generator=gen)
            w2 = 0.1 * torch.randn((c, c, 3, 3), generator=gen)
            b1, b2 = 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen)
            x = torch.randn(shape, generator=gen)
            for dt in (torch.bfloat16, torch.float32):
                ragged.append(('stem_convs', stem_convs,
                               tuple(t.cuda() for t in (x.to(dt), w1, b1, w2, b2)), {}))
        for shape, c in RAGGED_PAIR:
            ws = 0.08 * torch.randn((4, c, c, 3, 3), generator=gen)
            bs = 0.1 * torch.randn((4, c), generator=gen)
            x = torch.randn(shape, generator=gen).relu()
            ragged.append(('basic_pair', basic_pair,
                           (x.cuda(), ws.cuda(), bs.cuda()), {}))
        for name, op, args, kw in ragged:
            check_against_plain(name, op, args, kw, TOL_KERNEL, errs[name])

    with phase('4 model'):
        # a trace short of some launches and over in none is the
        # profiler's failure (see traced_forward): the run goes again with
        # a fresh eval step, and that trace must show every launch
        for attempt in (0, 1):
            kernels.reset_launch_counts()
            device = {}
            with device_trace(device):
                res = inference_model(model, imgs, impl='cuda')
            launches = kernels.launch_counts()
            # one eager warm-up forward and N_IMAGES replays ran on the device
            forwards = N_IMAGES + model._eval_step.captures
            want = {n: c * forwards for n, c in per_forward.items()}
            if attempt or not short_trace(device, want):
                break
            say(f'  the device trace saw {device}, not {want}; running '
                'inference_model again with a fresh eval step')
            del model.__dict__['_eval_step']
        say(f'  wrapper launches (one eager warm-up forward, one capture): '
            f'{launches}')
        say(f'  CUDA launches on the device (trace of {forwards} forwards, '
            f'{N_IMAGES} of them replayed): {device}')
        if not all(c for n, c in launches.items() if n not in OFF_PATH):
            raise AssertionError(f'a kernel never launched: {launches}')
        if device != want:
            raise AssertionError(f'the device ran {device} kernel launches, '
                                 f'not {want}')
        plain = inference_model(model, imgs, impl='plain')
        for i, (a, b) in enumerate(zip(res, plain)):
            la, lb = a['seg_logits'], b['seg_logits']
            if la.shape != (SIZE, SIZE, 19) or a['pred_sem_seg'].shape != (SIZE, SIZE):
                raise AssertionError(f'image {i}: shape {la.shape}')
            if not np.isfinite(la).all():
                raise AssertionError(f'image {i}: non-finite logits')
            e = np.abs(la - lb).max() / np.abs(lb).max()
            agree = (a['pred_sem_seg'] == b['pred_sem_seg']).mean()
            say(f'  image {i}: kernels vs module forms rel {e:.3e} '
                f'(tol {TOL_MODEL:g}), argmax agreement {agree:.6f}, '
                f'max|logit| {np.abs(lb).max():.3f}')
            if not (e <= TOL_MODEL and agree >= MIN_ARGMAX_AGREEMENT):
                raise AssertionError(f'image {i}: kernel path disagrees')
        # a caller's defaults: torch runs cuDNN's float32 convs in TF32
        # (allow_tf32 True) and float32 matmuls in full float32; the module
        # forms above ran with TF32 off
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = inference_model(model, imgs)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        for i, (a, b) in enumerate(zip(tf32, plain)):
            la, lb = a['seg_logits'], b['seg_logits']
            e = np.abs(la - lb).max() / np.abs(lb).max()
            agree = (a['pred_sem_seg'] == b['pred_sem_seg']).mean()
            say(f'  image {i}: inference_model under torch defaults (cuDNN '
                f'TF32 on) vs float32 module forms rel {e:.3e} (tol '
                f'{TOL_MODEL:g}), argmax agreement {agree:.6f}')
            if not (np.isfinite(la).all() and e <= TOL_MODEL
                    and agree >= MIN_ARGMAX_AGREEMENT):
                raise AssertionError(f'image {i}: TF32 defaults change the '
                                     f'answer')
        small = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
        gpu = inference_model(model, small)
        cpu = inference_model(copy.deepcopy(model).to('cpu'), small)
        e = np.abs(gpu['seg_logits'] - cpu['seg_logits']).max() / \
            np.abs(cpu['seg_logits']).max()
        agree = (gpu['pred_sem_seg'] == cpu['pred_sem_seg']).mean()
        say(f'  256x256: GPU kernels vs CPU module forms rel {e:.3e} '
            f'(tol {TOL_MODEL:g}), argmax agreement {agree:.6f}')
        if not (e <= TOL_MODEL and agree >= MIN_ARGMAX_AGREEMENT):
            raise AssertionError('GPU and CPU disagree')

    with phase('5 timing'):
        def forward(impl):
            def run():
                x, _, _ = model.data_preprocessor(x_dev, impl=impl)
                return model.predict(x, impl)
            return run
        with torch.inference_mode():
            fwd_ms = cuda_ms(forward('cuda'), reps=50, warmup=5)
            plain_fwd_ms = cuda_ms(forward('plain'), reps=50, warmup=5)
        say(f'  forward 1x{SIZE}x{SIZE} kernel path: {fwd_ms:.3f} ms '
            f'({1000 / fwd_ms:.1f} img/s); module forms: {plain_fwd_ms:.3f} ms '
            f'({1000 / plain_fwd_ms:.1f} img/s)')
        rows = []
        for name, (source, replaces) in KERNEL_INFO.items():
            mine = [(op, args, kw) for n, op, args, kw in calls + pyr_calls
                    if n == name]
            ms = plain_ms = bound = old_bound = 0.0
            bound_by = {'bytes': 0.0, 'operations': 0.0}
            with torch.inference_mode():
                for op, args, kw in mine:
                    t = cuda_ms(lambda: op(*args, **dict(kw, impl='cuda')), 20)
                    t_plain = cuda_ms(lambda: op(*args, **dict(kw, impl='plain')), 20)
                    b, by, b_f32 = bounds_ms(name, args, kw)
                    ms, plain_ms, bound = ms + t, plain_ms + t_plain, bound + b
                    old_bound += b_f32
                    bound_by[by] += b
                    if name == 'sesp_block':
                        say(f'    {name} {shape_of(args)} rates '
                            f'{tuple(kw["rates"])} stride {kw["stride"]}: '
                            f'{t:.4f} ms, bound {b:.4f} ms, plain '
                            f'{t_plain:.4f} ms')
            k = len(mine)
            rows.append(dict(
                name=name, route='cuda', source=source, replaces=replaces,
                launches=launches[name], device_launches=device[name],
                max_abs_err=max(errs[name]),
                ms=ms / k, plain_ms=plain_ms / k, bound_ms=bound / k,
                bound_by=max(bound_by, key=bound_by.get), library_ms=None))
            units = ('TF32 tensor cores, 3xTF32' if name in TENSOR_CORE_KERNELS
                     else 'float32 pipes')
            path_calls = sum(1 for n, *_ in calls if n == name)
            say(f'  {name}: {ms / k:.4f} ms/launch, {path_calls} launches '
                f'({per_forward[name]} CUDA launches)/forward, bound {bound / k:.4f} ms '
                f'({rows[-1]["bound_by"]}, {units}; float32-pipe bound '
                f'{old_bound / k:.4f} ms), plain {plain_ms / k:.4f} ms')
            earlier = {'sesp_block': ' / '.join(f'{t:.4f}' for t in EARLIER_SESP_MS),
                       'stem_convs': f'{EARLIER_STEM_MS:.4f}',
                       'basic_pair': f'{EARLIER_PAIR_MS:.4f}'}
            if name in earlier:
                say(f'  {name} before its redesign (same card type): '
                    f'{earlier[name]} ms/launch')
        # kernel E at both sets, per shape: device time (CUPTI), CUDA-event
        # time, bound, plain version and cuDNN's three-call composition;
        # summed beside E's device time before its redesign
        e_row = next(r for r in rows if r['name'] == 'sesp_pyramid')
        for set_name in ('flagship', 'val'):
            tot = dict(device=0.0, ms=0.0, plain=0.0, bound=0.0, cudnn=0.0)
            with torch.inference_mode():
                for _, op, args, kw in pyr_sets[set_name]:
                    red, dw1, dw2, rates = args
                    def run():
                        return op(*args, **dict(kw, impl='cuda'))
                    def plain():
                        return op(*args, **dict(kw, impl='plain'))
                    cudnn = cudnn_pyramid(dw1, dw2, rates, kw['stride'])
                    e_cudnn = rel(cudnn(red), plain())
                    if not e_cudnn <= 1e-4:
                        raise AssertionError(f'the cuDNN composition misses '
                                             f'the pyramid: rel {e_cudnn:.3e}')
                    t = dict(device=device_ms(run, 'sesp_pyramid'),
                             ms=cuda_ms(run, 20), plain=cuda_ms(plain, 20),
                             bound=bounds_ms('sesp_pyramid', args, kw)[0],
                             cudnn=cuda_ms(lambda: cudnn(red), 20))
                    tot = {key: tot[key] + t[key] for key in tot}
                    say(f'    [{set_name}] sesp_pyramid {shape_of(args)} rates '
                        f'{tuple(rates)} stride {kw["stride"]} v2 '
                        f'{dw2 is not None}: device {t["device"]:.4f} ms, '
                        f'{t["ms"]:.4f} ms, bound {t["bound"]:.4f} ms, plain '
                        f'{t["plain"]:.4f} ms, cuDNN composition '
                        f'{t["cudnn"]:.4f} ms (rel {e_cudnn:.1e})')
            k = len(pyr_sets[set_name])
            say(f'  sesp_pyramid [{set_name}] over {k} calls: device '
                f'{tot["device"]:.4f} ms (before its redesign '
                f'{EARLIER_PYRAMID_MS[set_name]:.4f} ms, same card type), '
                f'{tot["bound"] / tot["device"]:.3f} of the bound '
                f'{tot["bound"]:.4f} ms; CUDA events {tot["ms"]:.4f} ms, plain '
                f'{tot["plain"]:.4f} ms, cuDNN composition {tot["cudnn"]:.4f} '
                f'ms; on {card}')
            prefix = '' if set_name == 'flagship' else 'val_'
            if set_name == 'val':
                e_row.update(val_ms=tot['ms'] / k, val_plain_ms=tot['plain'] / k,
                             val_bound_ms=tot['bound'] / k)
            e_row.update({f'{prefix}device_ms': tot['device'] / k,
                          f'{prefix}cudnn_composition_ms': tot['cudnn'] / k})
        # no later phase runs kernel E: its maps (in the sets, phase 3b's
        # last set of entries and phase 5's last list of calls) go, and so
        # do the blocks the allocator cached for them, so that the later
        # phases' peak memory counts none of them
        del pyr_sets, pyr_calls, entries, mine, red, dw1, dw2, args, cudnn
        torch.cuda.empty_cache()

    from lednet_tpu_torch.config import Config
    from lednet_tpu_torch.engine import (build_optimizer, create_train_state,
                                         make_eval_step, make_train_step)
    with phase('6 train'):
        train_model = init_model(CONFIG, device='cuda',
                                 generator=torch.Generator().manual_seed(SEED + 1))
        cfg = train_model.cfg
        opt, sched = build_optimizer(train_model, cfg.optim_wrapper,
                                     cfg.param_scheduler)
        train = make_train_step(train_model, opt, train_model.data_preprocessor)
        state = create_train_state(train_model, opt, sched)
        t_imgs, t_lbl = (t.cuda() for t in train_batch(rng, TRAIN_BATCH, SIZE))
        torch.cuda.reset_peak_memory_stats()
        for flags, n in (('TF32 off', 1 + TRAIN_STEPS),
                         ("torch's defaults, cuDNN TF32 on", 3)):
            torch.backends.cudnn.allow_tf32 = flags != 'TF32 off'
            times = []
            for i in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, logs = train(state, t_imgs, t_lbl)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                vals = {k: v.item() for k, v in logs.items()}
                say(f'  step {state.step} ({flags}): ' + ', '.join(
                    f'{k} {v:.5f}' for k, v in vals.items()) +
                    f', {times[-1]:.3f} ms')
                if not all(np.isfinite(v) for v in vals.values()):
                    raise AssertionError(f'step {state.step}: non-finite logs')
            ms = sum(times[1:]) / (n - 1)
            say(f'  train step, bs {TRAIN_BATCH} at {SIZE}x{SIZE} ({flags}): '
                f'{ms:.3f} ms/step ({TRAIN_BATCH * 1000 / ms:.2f} img/s) over '
                f'{n - 1} steps after a warm-up, on {card}')
        torch.backends.cudnn.allow_tf32 = False
        say(f'  peak memory allocated: '
            f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
        del train_model, opt, train, state, t_imgs, t_lbl, logs
        torch.cuda.empty_cache()
        for seed in TRAIN_CHECK_SEEDS:
            s_imgs, s_lbl = train_batch(np.random.default_rng(seed), 2, 256)
            for name, extra in (("the config's OHEM losses", {}),
                                ('CrossEntropyLoss',
                                 {'model.decode_head.loss_decode': CE_LOSSES})):
                cfg = Config.fromfile(CONFIG)
                cfg.merge_from_dict(dict(
                    {'model.data_preprocessor.size': (256, 256)}, **extra))
                cpu_run = train_once(cfg, 'cpu', s_imgs, s_lbl, seed)
                with torch.backends.cudnn.flags(enabled=False):
                    own_convs = train_once(cfg, 'cuda', s_imgs, s_lbl, seed)
                hold_train(f'one step, seed {seed}, 2x256x256, {name}, '
                           "PyTorch's own CUDA convs", own_convs, cpu_run,
                           ('weights', 'bn_stats'))
                hold_train(f'one step, seed {seed}, 2x256x256, {name}, cuDNN',
                           train_once(cfg, 'cuda', s_imgs, s_lbl, seed),
                           cpu_run, ('bn_stats',))

    with phase('7 eval graph'):
        step = make_eval_step(model, model.data_preprocessor)

        def eager():
            x, _, _ = model.data_preprocessor(x_dev, impl='cuda')
            return model.predict(x, 'cuda')
        with torch.inference_mode():
            ref = eager()
            check_logits('replay vs eager kernel path', step(x_dev), ref)
        opt, sched = build_optimizer(model, model.cfg.optim_wrapper,
                                     model.cfg.param_scheduler)
        b_imgs, b_lbl = (t.cuda() for t in train_batch(rng, 2, SIZE))
        make_train_step(model, opt, model.data_preprocessor)(
            create_train_state(model, opt, sched), b_imgs, b_lbl)
        model.eval()
        with torch.inference_mode():
            ref2 = eager()
            moved = (ref2 - ref).abs().max().item()
            check_logits('replay after a train step vs eager', step(x_dev), ref2)
        say(f'  the train step moved the logits by up to {moved:.3e}; graphs '
            f'captured by the step: {step.captures}')
        if not (moved > 0 and step.captures == 2):
            raise AssertionError('the step did not capture again after the '
                                 'weights changed')
        res = inference_model(model, imgs[0])
        check_logits('inference_model vs eager',
                     torch.from_numpy(res['seg_logits']), ref2[0].cpu())
        with torch.inference_mode():
            replay_ms = cuda_ms(lambda: step(x_dev), reps=50, warmup=5)
            eager_ms = cuda_ms(eager, reps=50, warmup=5)
        say(f'  forward 1x{SIZE}x{SIZE}: replayed graph {replay_ms:.3f} ms '
            f'({1000 / replay_ms:.1f} img/s), eager kernel path {eager_ms:.3f} '
            f'ms ({1000 / eager_ms:.1f} img/s); graphs captured: step '
            f'{step.captures}, inference_model {model._eval_step.captures}')
        with torch.inference_mode():
            sync_replay, sync_eager = (synced_ms(f, reps=50, warmup=5)
                                       for f in (lambda: step(x_dev), eager))
        t0 = time.perf_counter()
        for _ in range(200):
            step.weights_key()
        key_ms = (time.perf_counter() - t0) / 200 * 1e3
        say(f'  one frame at a time (host clock, synchronized after each of '
            f'50 calls): replayed graph {sync_replay:.3f} ms, eager kernel '
            f'path {sync_eager:.3f} ms; host time of the step\'s weights '
            f'check {key_ms:.3f} ms per call')

    with phase('8 entry points'):
        entry_launches, entry_device = entry_points(model, card, per_forward)
    with phase('9 branch'):
        branch_launches, branch_device, branch_errs = branch_path(card, per_forward)
    with zoo_tree() as tree:
        with phase('10 zoo'):
            zoo_launches, zoo_device, zoo_a_err = zoo_models(card)
            zoo_entry_points(card, tree, *ZOO[0])
        with phase('11 pidnet stdc'):
            pid_launches, pid_device, pid_a_err = zoo_models(
                card, PID_STDC, PID_STDC_WIDE)
            zoo_entry_points(card, tree, *PID_STDC[0])
        with phase('12 bisenetv2 hrnet'):
            bh_launches, bh_device, bh_a_err = bise_hrnet(card, tree)
        with phase('13 segnext'):
            sn_launches, sn_device, sn_a_err = segnext(card, tree)
        with phase('14 slide'):
            sl_launches, sl_device, sl_a_err = slide(card, tree)
        with phase('15 datasets'):
            ds_launches, ds_device, ds_a_err = datasets(card, tree)
        with phase('16 realtime'):
            rt_launches, rt_device, rt_a_err = realtime(card, tree)
        with phase('17 sctnet rtformer psp'):
            srp_launches, srp_device, srp_a_err = sct_rtformer_psp(card, tree)
        with phase('18 cascade transformers'):
            ct_launches, ct_device, ct_a_err = cascade_transformers(card, tree)
        with phase('19 knet mask2former'):
            km_launches, km_device, km_a_err = knet_mask2former(card, tree)
        with phase('20 san'):
            san_launches, san_device, san_a_err = san(card, tree)
        with phase('21 vit fpn'):
            vf_launches, vf_device, vf_a_err = vit_fpn(card, tree)
        with phase('22 context heads'):
            ch_launches, ch_device, ch_a_err = context_heads(card, tree)
    for row in rows:
        row['entry_point_launches'] = entry_launches[row['name']]
        row['entry_point_device_launches'] = entry_device[row['name']]
        row['branch_launches'] = branch_launches[row['name']]
        row['branch_device_launches'] = branch_device[row['name']]
        row['branch_max_abs_err'] = branch_errs.get(row['name'])
        row['zoo_launches'] = zoo_launches[row['name']]
        row['zoo_device_launches'] = zoo_device[row['name']]
        row['zoo_max_abs_err'] = (zoo_a_err if row['name'] == 'normalize_image'
                                  else None)
        row['pid_stdc_launches'] = pid_launches[row['name']]
        row['pid_stdc_device_launches'] = pid_device[row['name']]
        row['pid_stdc_max_abs_err'] = (pid_a_err if row['name'] ==
                                       'normalize_image' else None)
        row['bise_hrnet_launches'] = bh_launches[row['name']]
        row['bise_hrnet_device_launches'] = bh_device[row['name']]
        row['bise_hrnet_max_abs_err'] = (bh_a_err if row['name'] ==
                                         'normalize_image' else None)
        row['segnext_launches'] = sn_launches[row['name']]
        row['segnext_device_launches'] = sn_device[row['name']]
        row['segnext_max_abs_err'] = (sn_a_err if row['name'] ==
                                      'normalize_image' else None)
        row['slide_launches'] = sl_launches[row['name']]
        row['slide_device_launches'] = sl_device[row['name']]
        row['slide_max_abs_err'] = (sl_a_err if row['name'] ==
                                    'normalize_image' else None)
        row['datasets_launches'] = ds_launches[row['name']]
        row['datasets_device_launches'] = ds_device[row['name']]
        row['datasets_max_abs_err'] = (ds_a_err if row['name'] ==
                                       'normalize_image' else None)
        row['realtime_launches'] = rt_launches[row['name']]
        row['realtime_device_launches'] = rt_device[row['name']]
        row['realtime_max_abs_err'] = (rt_a_err if row['name'] ==
                                       'normalize_image' else None)
        row['sct_rtf_psp_launches'] = srp_launches[row['name']]
        row['sct_rtf_psp_device_launches'] = srp_device[row['name']]
        row['sct_rtf_psp_max_abs_err'] = (srp_a_err if row['name'] ==
                                          'normalize_image' else None)
        row['cascade_transformers_launches'] = ct_launches[row['name']]
        row['cascade_transformers_device_launches'] = ct_device[row['name']]
        row['cascade_transformers_max_abs_err'] = (
            ct_a_err if row['name'] == 'normalize_image' else None)
        row['knet_m2f_launches'] = km_launches[row['name']]
        row['knet_m2f_device_launches'] = km_device[row['name']]
        row['knet_m2f_max_abs_err'] = (km_a_err if row['name'] ==
                                       'normalize_image' else None)
        row['san_launches'] = san_launches[row['name']]
        row['san_device_launches'] = san_device[row['name']]
        row['san_max_abs_err'] = (san_a_err if row['name'] ==
                                  'normalize_image' else None)
        row['vit_fpn_launches'] = vf_launches[row['name']]
        row['vit_fpn_device_launches'] = vf_device[row['name']]
        row['vit_fpn_max_abs_err'] = (vf_a_err if row['name'] ==
                                      'normalize_image' else None)
        row['context_heads_launches'] = ch_launches[row['name']]
        row['context_heads_device_launches'] = ch_device[row['name']]
        row['context_heads_max_abs_err'] = (ch_a_err if row['name'] ==
                                            'normalize_image' else None)

    say(card)
    say(json.dumps({'kernels': rows}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except PhaseError:
        sys.exit(1)
