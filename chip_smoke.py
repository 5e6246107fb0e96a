#!/usr/bin/env python3
"""Drive the PyTorch port (``x2vlm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Run from the repository root, on a machine with a CUDA card and ``nvcc``.
Phases (any failure exits non-zero and prints no result line):

1. build every CUDA kernel of the port from ``x2vlm_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together, in the background: phase 2
   checks the flash kernels, built first, while the others compile) and,
   beside them, the native data plane from ``x2vlm_tpu_torch/csrc_host``
   (``g++``; below);
2. hold each kernel (flash forward, dQ, dK/dV, dBias; tiny forward and
   backward) against its plain PyTorch version on the card: at the main
   paths' shapes in bf16, with fp32 plain as truth and the rule
   kernel_err <= max(4 x plain_bf16_err, 1e-3 x max|truth|), and over the
   rest of each kernel's contract (key masks, fully masked rows, causal,
   Sq != Skv, per-batch and head-shared bias, dropout multiplier, fp32,
   other head dims: for the tiny kernels each one the tensor-core route
   builds, 16 to 128) at small shapes; time the kernel, its plain version and
   one PyTorch library call (SDPA forward or backward) with CUDA events,
   the card running ahead of the host (the flash forward at B=128, at the
   step's B=32 and at the region stream's B=50 images, and at 384 px
   (S=577) at the grounding step's B=20, the 32 images of the NLVR2 step
   and the 64 of the NLVR2 eval; the flash backward at B=32 and B=50, and
   at S=577 at B=20 and B=32, beside two SDPA backwards, dq/dk/dv with the
   bias as a constant and all four gradients; dBias must be the same bit
   for bit in two launches; the tiny kernels at every 40 x 40 and 40 x 200
   shape of the main paths, with serving or training operands as the path
   gives them, the region stream's 40 x 200 calls with region bitmaps as
   key masks). The tiny
   kernels (``tiny_route``) and
   the four flash kernels (``flash_route``) have two routes: the main
   paths' bf16 D=64 launches must take the tensor-core route, fp32 and bf16
   at other head dims the CUDA-core route; the C route rules, each route's
   shared-memory formulas and the dBias group count must equal the Python
   ones;
3. the serving path: X2VLM-base at 224 px with weights drawn from
   ``--seed`` serves ``encode_images`` (128 images), ``encode_texts`` (128
   texts of 40 tokens, some padded) and ``itm_score`` (128 pairs) through
   ``RetrievalServer``; the launch counts of each request are read and
   checked (12 flash per image batch, 12 tiny per text batch, 12 tiny per
   rerank batch, every flash and tiny launch on the tensor-core route),
   outputs are checked for shape and finiteness, and the requests are
   timed; the same weights on the port's CPU path in fp32 for 2 rows,
   against the card's rows;
4. K7, the int8 matmul (its quantize and GEMM kernels), at every shape of
   the int8 serving path and over its contract (M off every tile, 3-D
   input, no bias, each activation, fp32 in and out, zero rows, an
   outlier, odd N, K off the 128-byte K tile, K = 16, M and N on either
   side of the 128 x 128 tile, a tile count that is no multiple of the
   SM count): (xq, sx) and, without an activation, the output must equal
   the plain version bit for bit; with one, within 1e-6 x max|out| in fp32
   and one bf16 ulp (2^-7 x max|out|) in bf16. The GEMM's C plan and
   shared memory must equal the Python mirror (``GEMM_PLAN``,
   ``gemm_smem_bytes``). Timed beside its plain version, ``torch._int_mm``
   on the same int8 operands and the bf16 ``F.linear`` of the float path;
5. the int8 serving path: X2VLM-base with ``quant_int8`` and the tanh GELU
   on both towers (``bench.py``'s ``X2VLM_BENCH=int8`` variant), loaded
   from phase 3's state dict, serves the same requests; launches checked
   (K7 GEMM / quantize 48 / 48 per image batch, 72 / 48 per text batch,
   60 / 42 per rerank batch; attention as in phase 3), int8 against bf16
   with the same weights and GELU (feature cosine >= 0.99), card int8
   against the port's CPU fp32 int8 path on 2 rows, requests timed beside
   the bf16 ones;
6. the training path: X2VLM-base pretraining steps (ITC + ITM + MLM,
   AdamW, ``lr_schedule(1e-4, 1000, 100)``) at B=32, 40 tokens, 12 masked,
   uint8 images, the config's dropouts on; the launch counts of one step
   are read and checked (12 flash forward / dQ / dK-dV / dBias, all on the
   tensor-core route; tiny forward and backward 12 + 6 at
   40x40 and 6 at 40x200, all on the tensor-core route), the losses and
   the gradient norm must be finite, the step is timed (median of 7 after
   2 warm-up steps) with its peak device memory; then the same weights
   with dropout off at B=2 and injected hard negatives, card bf16 against
   the port's CPU fp32 path: losses, and gradient cosines >= 0.99; and the
   region step (2 images, 6 region rows of 1 to 40 patches, a full-image
   row, a degenerate target) likewise: its five losses (ITC, ITM, MLM,
   bbox L1, GIoU) within 0.05 + 2%, gradient cosines >= 0.99 in the vision
   tower, a fusion layer and the ITM and bbox heads, and each bf16 40 x 200
   call of its ITM + MLM fusion pass (region bitmaps as key masks) held on
   the model's operands to the plain version, within half the bf16 rule
   (the box targets off the L1 and GIoU losses' kinks, ``off_kink_targets``;
   ``tools/region_kink_witness.py`` reads why);
7. the launcher's pretraining task, ``x2vlm_tpu_torch.run.main`` in process
   on data written to a temporary directory while the kernels build (a
   30,522-entry BERT vocab
   drawn from ``--seed``, 256 base64 PNG image-text lines of 256 px, 64
   region lines of 256 px with 1-6 boxes each and 64 text lines):
   ``configs/pretrain/x2vlm_base_4m.yaml`` read with the port's
   ``load_config``, the data paths pointed there, the image and region
   blocks as shipped (128 images; 128 rows over 50 images a step), a text
   stream added at batch 32, a save after 2 steps; 2 steps (their
   ``--resume`` is held by phase 24). Checked: finite losses (the region
   stream's bbox L1 and GIoU among them), no broken sample, the launches of
   the 2 steps (24 of each flash kernel a step on the tensor-core route, 12 at
   B=128 and 12 at B=50; tiny forward and backward 12 at 256 x 40 x 40, 6
   at 512 x 40 x 40 and 512 x 40 x 200 for the image stream, 18 at 32 x 40
   x 40 for the text stream and the region stream's, all tensor-core, all
   on the resident walk; no plain attention), each region-stream call's own
   launches (12 of each flash kernel; tiny at 256 x 40 x 40 x12, 512 x 40
   x 40 x6, 512 x 40 x 200 x6, 128 x 40 x 40 x6, 128 x 40 x 200 x6); each
   stream's CUDA-event and wall ms and peak device memory printed; the
   final weights exported as a reference-named ``.th``;
8. the launcher's retrieval task at 384 px from that ``.th`` (rel-pos
   tables interpolated 14 -> 24): ``configs/finetune/retrieval_flickr_base
   .yaml`` with the data paths pointed at 64 PNG images of 320 px with 5 captions each, 4
   fine-tune steps at batch 32, then the two-stage eval with k_test 128.
   Checked: nothing missing in the import (left over: the MLM and bbox
   heads, which a retrieval model does not carry), the eval metrics of
   ``itm_eval`` finite, every flash launch (S = 577) on the tensor-core
   route, every tiny launch on the tensor-core route and each 40 x 584 one
   on the key-tiled walk, no plain attention, the launch counts; and the
   fine-tuned model's own ``itm_score`` on 2 x 4 pairs on the card in bf16
   (tensor-core kernels) and in fp32 (CUDA-core kernels) against the
   port's CPU fp32 path: each bf16 40 x 584 call into K5 held to the plain
   version on the operands the model gave it (half the bf16 rule), the fusion
   CLS features' error over the pairs' spread within ``FUSION_LIMITS``,
   the ITM scores within phase 3's rule, the 40 x 584 launches key-tiled
   on their route (``tools/fusion384_faults.py`` reads this hold on
   copies with planted faults); fine-tune step times and the eval's wall
   time are printed;
9. the launcher's grounding and NLVR2 fine-tunes at 384 px from phase 7's
   ``.th``: ``configs/finetune/refcoco_grounding_base.yaml`` and
   ``nlvr_base.yaml`` at their own batch sizes (20 and 16 a step, 32 an
   eval call), the data paths pointed at phase 8's PNGs (RefCOCO-style
   lines with pixel boxes, some texts naming left or right, a
   ``refs_file`` over the val / testA / testB splits; NLVR2 lines with two
   images and a True / False label), cut to 4 fine-tune steps and 64 eval
   lines each. Checked: finite losses and eval metrics (``val_acc`` per
   split, ``accuracy``); the import (grounding: nothing missing, its bbox
   head from the ``.th``; NLVR2: only ``cls_head`` fresh); the launches of
   each step and eval call (a grounding step: 12 of each flash kernel at
   B=20, tiny forward and backward 18 at 20 x 40 x 40 and 6 at 20 x 40 x
   584 without a multiplier; an NLVR2 step: 12 of each flash kernel at 32
   images, tiny 24 at 16 x 40 x 40 and 12 at 16 x 40 x 584; an eval call
   at batch 32: 12 flash forwards, tiny 18 + 6 or 24 + 12), every flash
   launch on the tensor-core route, every 40 x 584 launch key-tiled, no
   plain attention; grounding's ``--resume``, whose restored parameters
   and AdamW state must equal the saved ones bit for bit; and the
   fine-tuned weights on 2 rows with dropout off, card bf16 against the
   port's CPU fp32 path: grounding's boxes within 0.02, NLVR2's logits
   within 0.05 + 5% of their scale, the losses within 0.05 + 2%, gradient
   cosines >= 0.99 (the vision tower, a fusion layer, the task's head),
   and each bf16 40 x 584 call of the card's pass into the tiny forward
   and backward held on the model's operands to the plain version (the
   backward's taking its row sums from the forward's output, as the kernel
   does), within half the bf16 rule. Step times (CUDA events and wall), the
   eval's wall seconds and the peak device memory of each are printed;
10. the launcher's VQA fine-tune at 768 px from phase 7's ``.th`` (rel-pos
   tables interpolated 14 -> 48, the answer decoder fresh):
   ``configs/finetune/vqa2_base.yaml`` at its own sizes (8 questions and
   16 answer rows a step, 32 questions an eval call, k_test 128, 40
   question and 10 answer tokens), the data paths pointed at phase 8's PNGs
   (resized to 768 by the transforms), a written answer list of 3,000
   answers and question lines (train: 10 human answers or a ``weight``
   field; test: half with 10 human answers, half with one), cut to 2
   epochs of 2 steps, the eval of 64 questions (two calls) after the last;
   then ``--resume`` from the state saved at step 2. Checked: finite
   losses, ``overall`` and ``acc``, ``vqa_result.json``; the import (only
   the decoder fresh; the table interpolated 14 -> 48); the launches of
   each step (12 of each flash kernel at B=8, S=2305; tiny forward and
   backward 18 at 8 x 40 x 40, 6 key-tiled at 8 x 40 x 2312 and 6 at 16 x
   10 x 40; the 6 causal decoder self-attentions on the plain core) and
   eval call (12 flash forwards at B=32; tiny 18 at 32 x 40 x 40, 6 at 32
   x 40 x 2312, 6 at 32 x 1 x 40 and 6 at 4096 x 10 x 40; 12 plain), every
   launch on the tensor-core route, the plain attention's calls exactly
   those; the resumed state equal to the saved one and its batches (data
   cursor, answer-cut rng) equal to the whole run's bit for bit; and the
   fine-tuned weights on 2 questions with dropout off, card bf16 against
   the port's CPU fp32 path: ``loss_vqa`` within 0.05 + 2%, gradient
   cosines >= 0.99 (the vision tower, a fusion layer, a decoder layer, the
   decoder head), each bf16 40 x 2312 forward and backward call within
   half the bf16 rule, ``rank_answer``'s first answers equal and its top-k
   scores within 0.05. The step's CUDA-event and wall ms, the eval's wall
   seconds and both peaks are printed;
11. the launcher's captioning fine-tune at 384 px from phase 7's ``.th``
   (rel-pos tables interpolated 14 -> 24, nothing fresh):
   ``configs/finetune/coco_captioning_base.yaml`` at its own sizes (16
   images a step and an eval call, 25 tokens, 12 masks, label smoothing
   0.1, 3 beams, captions of 5 to 20 tokens after "a picture of "), the
   data paths pointed at phase 8's PNGs (Karpathy-style train / test lines
   with 5 captions an image, a ``caption_gt_file``), cut to 2 epochs of 2
   steps and an eval of 32 images (two calls) after the last; then
   ``--resume`` from the state saved at step 2; then ``scst: true`` from
   the fine-tuned state, 2 steps of 16 images x 5 rollouts. Checked:
   finite losses, BLEU-1 / 4, CIDEr-D, ROUGE-L and METEOR; the import; the
   launches of each step (12 of each flash kernel at B=16; tiny forward and
   backward 6 at 16 x 25 x 584; the 18 UniLM self-attentions on the plain
   core), eval call (12 flash forwards; tiny 6 at 16 x 5 x 584 and 6 x 19
   at 48 x 2 x 584; 18 x 20 plain: the cached decode), SCST rollout call
   (12 flash forwards; tiny 6 at 80 x 5 and 6 x 19 at 80 x 2 x 584; 18 x
   20 plain) and SCST step (12 of each flash kernel at B=80; tiny 6 at 80
   x 46 x 584; 18 plain), every launch tensor-core and key-tiled; the
   resumed state and its batches bit for bit; and the fine-tuned weights
   on 2 images with dropout off, card bf16 against the port's CPU fp32
   path: ``loss_caption`` and ``loss_scst`` (a 10-row SCST batch, 5
   reference captions an image, with planted non-zero advantages) each
   within 0.05 + 2% with gradient cosines >= 0.99, each 25 x 584 and 46 x
   584 forward and backward call within half the bf16 rule, a
   teacher-forced decode (each frame fed the CPU's greedy token) whose
   logits stay within 0.05 + 5% of their scale, frame 0's top-3 ids equal;
   the two paths' beam-search captions are printed, not held. Step, eval
   call, rollout call and SCST step ms (CUDA events, wall), the eval's wall
   seconds and the peaks are printed;
12. the launcher's retrieval task on the other two vision towers at 224 px:
   ``configs/finetune/retrieval_flickr_clip_base.yaml`` (CLIP ViT-B/16) and
   ``retrieval_flickr_swin_base.yaml`` (Swin-B/224, output width 1024),
   each with the 18-layer BERT-base, at their own sizes (32 a step, 64
   images an eval call, k_test 128) from weights drawn from ``--seed`` (no
   published file is in the repository), on phase 8's PNGs: 2 steps and
   the two-stage eval (64 images, 320 texts), each call's launches read
   (CLIP: 12 flash forward / dQ / dK-dV without a bias and no dBias a
   step; Swin: no flash launch, its 24 window attentions on the plain
   core; tiny at 40 x 40 and 40 x 200 / 40 x 56), ``--resume`` restoring
   the saved state bit for bit, 2 rows card bf16 against CPU fp32 (ITC and
   ITM within 0.05 + 2%, gradient cosines >= 0.99, each 40 x 200 / 56
   fusion call within half the bf16 rule), the trained state exported with
   ``python -m x2vlm_tpu_torch.export_serving`` and served by
   ``RetrievalServer.from_npz`` with the tower from the bundle's manifest
   (features equal to the trained model's), and its requests at B=128
   timed with their launches read;
13. the video path at 224 px (X2VLM-base, BEiT-2 over batch x frames, the
   frame positions added, the mean over frames): (a) the launcher's
   ``--task pretrain`` on ``configs/pretrain/x2vlm_base_1b_stage2_video
   .yaml`` from phase 7's ``.th`` (its frame positions fresh), the image
   stream as shipped (128) on phase 7's lines, the region block as shipped, the
   video block as shipped (40 videos x 3 frames = 120 frames a call) on 64
   lines of 8 base64 PNG frames written here (a quarter of them
   clip-of-clips lines); 2 steps, then ``--resume`` to step 3, the state
   and the data cursors (the video cursor among them) restored bit for bit,
   each video call's launches read (12 of each flash kernel at 120 frames;
   tiny 80 x 40 x 40 x12, 160 x 40 x 40 x6, 160 x 40 x 200 x6), the final
   weights exported as ``x2vlm_phase13.th``; (c) the stage-2 weights on 2
   videos, card bf16 against CPU fp32 with the negatives injected (ITC /
   ITM / MLM, gradient cosines, each 40 x 200 fusion call within half the
   bf16 rule); (b) ``--task video_qa`` on ``configs/finetune/
   vqa_msrvtt_base.yaml`` at its own sizes (8 videos x 5 frames a step, 16
   videos an eval call) from that ``.th`` (3 frame positions into 5: the
   first three loaded, two fresh; ``cls_head`` fresh over a 1,500-answer
   list), 2 epochs of 2 steps and an eval of 32 videos, each step (12 of
   each flash kernel at 40 frames, tiny 18 at 8 x 40 x 40 and 6 at 8 x 40 x
   200) and eval call (12 flash at 80 frames, tiny 18 + 6 at 16 rows)
   read, no plain attention, ``--resume`` from step 2 restoring the state
   and the batches bit for bit, and (c) the fine-tuned weights on 2 videos,
   card bf16 against CPU fp32 (``loss_cls``, logits, gradient cosines, each
   40 x 200 call). Train states go to ``/dev/shm``;
14. the Plus / CCLM base at 224 px (BEiT-2-base, XLM-R-base's 12 layers
   over 64-token texts and a 250,002-row vocabulary, a 6-layer cross
   encoder): the launcher's ``--task pretrain`` on
   ``configs/pretrain/cclm_x2vlm_base.yaml`` from phase 7's ``.th``
   (``is_xvlm_ckpt`` with ``replace_text_encoder``: its text layers 12-17
   become the cross encoder, XLM-R starts fresh from ``--seed``), a written
   250,002-entry XLM-R ``tokenizer.json`` read by the port's own tokenizer,
   phase 7's images with captions keyed by the config's eight languages,
   its region lines (monolingual: the shipped region block sets no
   ``languages``) and 256 written parallel lines; the image block (128
   images), the region block (128 rows over 50 images) and the
   parallel-text block (128 pairs of 64 tokens) as shipped; 2 steps, then
   ``--resume`` from the state of step 1. Checked: the import (XLM-R and
   the MLM decoder bias fresh, nothing unexpected), finite losses of the
   three streams, the launches of the run and of each stream call (image:
   12 of each flash kernel at B=128, tiny 30 at 128 x 64 x 64, 6 at 384 x
   64 x 64, 384 x 64 x 200 and 128 x 64 x 200; region: 12 at B=50, tiny
   36 at 128 x 64 x 64, 6 at 384 x 64 x 64 and 384 x 64 x 200, 12 at 128 x
   64 x 200; parallel text: no flash, tiny 48 at 128 x 64 x 64 and 12 at
   384 x 64 x 64), all tensor-core, no plain
   attention; the restored state and cursors (the parallel text's among
   them) bit for bit; then the weights on 2 images, 2 region rows and 2
   parallel pairs, card bf16 against CPU fp32 with the negatives injected:
   every loss within 0.05 + 2%, gradient cosines >= 0.99 (XLM-R's table
   and a layer, the cross encoder's self- and cross-attention among them),
   each bf16 call with 200 or 64 keys into K5 and K6 within half the bf16
   rule; and the fused MLM CE timed at 250,002 rows. Each stream call's
   CUDA-event and wall ms and peak memory are printed;
15. the IGLUE tasks on the Plus base at 384 px: the launcher's ``--task
   xvnli``, ``marvl``, ``xgqa``, ``wit`` and ``xflickrco`` on the five
   shipped ``configs/finetune/*_cclm_base.yaml`` at their own sizes (16
   rows a step, 32 an eval call, k_test 128; 40 tokens, WIT's and
   xFlickrCO's 80; xGQA's 6-layer RoBERTa-form decoder over 10-token
   answers), each from phase 14's Plus train state (``--checkpoint <dir>``,
   memory-mapped, the task's head fresh) with phase 14's XLM-R tokenizer,
   on data written over phase 8's PNGs: ``{lang: path}`` test sets of two
   languages (MARVL's: NLVR2's ``en`` and a MARVL ``zh`` set; WIT's and
   xFlickrCO's one, ``RET_EVAL_LANGS``), WIT's rows with base64 images,
   xGQA's lists of 1,000 answers (one language's a [path, list] pair), 128
   test lines a language for WIT and xFlickrCO so the rerank takes 128
   candidates both ways. 2 steps and the eval each;
   xGQA in 2 epochs of a step, then ``--resume`` from step 1 (its restored
   state and next batch bit for bit); XVNLI once more as ``--task
   classification`` (its ``dataset_type``) under ``--fewshot de,16`` (a
   two-slot train template, a one-slot test template), one step and its
   eval. Checked: the import (only the task's head fresh), finite losses
   and per-language metrics, each step's and eval call's launches (XVNLI:
   12 of each flash kernel at B=16, tiny 18 at 16 x 40 x 40 and 6 at 16 x
   40 x 584; MARVL as phase 9's NLVR2; xGQA as XVNLI plus 6 at 32 x 10 x 40
   and 6 plain causal self-attentions, an eval call 12 flash, tiny 18 + 6
   at 32 rows, 6 at 32 x 1 x 40 and 48 at 512 x 10 x 40 (the rank pass in
   8 chunks), 54 plain; WIT / xFlickrCO: no tiny launch at 80 tokens, 24
   plain calls a step at 16 x 80 x 80, 48 x 80 x 80 and 48 x 80 x 584, a
   language's eval 48 flash at B=32 and 396 plain), every plain call
   counted by shape; xGQA's rank pass at Q = 32, k = 128 timed with its
   peak memory (under the card's); then the fine-tuned weights of each head
   family (retrieval at 80 tokens, NLVR2 / MARVL, XVNLI, xGQA) on 2 rows,
   card bf16 against CPU fp32: losses within 0.05 + 2%, logits and ITM
   scores within 0.05 + 5% of their scale, gradient cosines >= 0.99, each
   40 x 584 call within half the bf16 rule (none at 80 tokens), xGQA's
   first answers equal and its top-k scores within 0.05. Step and eval ms
   (CUDA events, wall) and peaks are printed;
16. X2VLM-large pretraining (BEiT-2-large, 24 blocks of width 1024, and
   the 18-layer BERT-large: 16 heads everywhere): the launcher's ``--task
   pretrain`` on the shipped ``configs/pretrain/x2vlm_large_4m.yaml`` at
   its own sizes (64 images at 224 px, the region block's 64 rows over 25
   images, no remat) from ``--seed`` weights on phase 7's image and region
   lines, 2 steps, the state saved once at the end, in memory (its
   parameters, which the ``.th`` and the holds read); no
   ``--resume`` (the code phases 7 and 10 hold bit for bit; a resume of
   this model loads an ~11 GB state). Checked: finite losses, the launches
   of the run and of each stream call (image: 24 of each flash kernel at
   B=64, tiny 12 at 128 x 40 x 40, 6 at 256 x 40 x 40 and 256 x 40 x 200;
   region: 24 at 25 images, the same tiny and 6 at 64 x 40 x 40 and 64 x
   40 x 200), every one at 16 heads and on the tensor-core route, no plain
   attention; the weights exported as a reference-named ``.th``. Then the
   remat hold on the card (2 images, the config's dropouts on, the same
   generator seeds): one step without remat, under ``dots`` and under full
   remat, the forward losses and the dropout generator's state after it
   equal bit for bit, each gradient family (the vision tower, a text
   layer, a fusion layer, the heads) within cosine 0.9999 and relative L2
   1e-3 of the plain step's, every block rematerialised; and the weights
   on 2 images and 2 region rows, card bf16 against CPU fp32 with the
   negatives injected (losses within 0.05 + 2%, gradient cosines >= 0.99,
   each 40 x 200 call within half the bf16 rule);
17. VQA on X2VLM-large at 768 px: the launcher's ``--task vqa`` on the
   shipped ``configs/finetune/vqa2_large.yaml`` at its own sizes (16
   questions a step, ``accumulate_steps`` 2: two microbatches of 8, each
   with the step's 32 answer rows; ``remat: true`` under ``dots``;
   ``large_lr_for_dec``; 32 questions an eval call, k_test 128) from phase
   16's ``.th`` (24 rel-pos tables interpolated 14 -> 48, the decoder
   fresh) on 32 train and 32 test questions written over phase 8's PNGs:
   one epoch of 2 steps and its eval, the state saved in memory (its
   parameters, which the holds below read). Checked: finite
   losses and metrics, the import, ``accum_steps`` 2 and the decoder at
   ``lr_mult``, the launches of each step and eval call (under remat each
   rematerialised layer's forward kernels launch twice a microbatch, its
   backward kernels once: ``large_vqa_launches``), every one at 16 heads,
   the 40 x 2312 ones key-tiled; then on the card from the run's weights,
   dropout off, the 16-question step split by question against the
   unsplit step (``loss_vqa`` within 0.05 + 2%, gradient cosines >=
   0.99), a step's CUDA-event ms and peak memory under ``dots``, full remat
   and no remat, and 2 questions card bf16 against CPU fp32 in training
   mode under ``dots`` (``loss_vqa``, gradient cosines, each 40 x 2312
   call, ``rank_answer``).

18-21. the remaining shipped pretraining configs at their own sizes
   through ``--task pretrain`` (``config_pretrain_phase``), 2 steps each,
   at the first ``--seed`` from the script's whose loop draws (the
   launcher's ``random.Random(--seed)``) give an aux and a noisy image
   batch, or a video and a video-aux batch, within the 2 steps (the draws
   are printed; the replacement probabilities stay as shipped): 18
   ``x2vlm_base_1b.yaml`` from ``--seed`` (128 images at 30 tokens beside
   the clean-data aux stream at 0.15, read by ``aux_caption_key``; 64
   region rows over 26 images at ``iter_perc`` 0.5); 19
   ``x2vlm_large_1b.yaml`` from ``--seed`` (BEiT-2-large and a 24-layer
   BERT-large stack fusing from 18, 16 heads; 128 images beside the aux
   stream, 128 region rows over 50 images; no remat: its aux image call
   peaks at ~74 GiB; it runs right after phase 8, while the holds' worker
   is idle); 20 ``x2vlm_large_1b_stage2.yaml`` from phase 16's ``.th``
   (frame positions fresh; 32 images, 32 region rows over 14 images, 20
   clips x 3 frames beside the video-aux stream at 0.35); 21
   ``multilingual_cclm_x2vlm_large.yaml`` from ``--seed`` (an X2VLM-large
   ``.th`` is refused by both launchers: ROADMAP C; BEiT-2-large at 16
   heads, XLM-R of 24 layers at the JAX preset's width 768 and 6 cross
   layers at 12; 30 images, 30 region rows over 14 images with
   ``code_switch`` over the block's eight ``languages``, the languages each
   image's captions were read in printed; the parallel-text block asserted
   as shipped but not run: its cross-attention to language 2 raises in
   both packages at these widths). Checked in each: the sizes against the
   YAML, finite losses, no broken sample, each stream call's launches (by
   its kind: an aux batch's ITM + MLM fusion over 4 x B rows, a noisy
   batch's MLM through the whole stack over B rows, no matching loss) and
   its matching flag, every launch tensor-core on the resident walk at
   the phase's head counts, no plain attention; each call's CUDA-event
   and wall ms and peak GiB; the state saved once, in memory (no later
   phase reads it), its parameters kept for the deferred card bf16 vs
   CPU fp32 hold (18: an aux, a noisy and a region batch at 30 tokens; 19:
   the same on the 24-layer stack at the run's weights, the ITM head's
   first weight held term by term, ``itm_term_faults``: each row's fused
   CLS features, each call's p - y and each row's gradient at cosine 0.99,
   the card's applied gradient against its own terms summed, and the
   summed gradient, a near-cancelling sum of them there, within 0.06 of
   the larger of its terms' scale and its norm; 20: 2 videos of 3 frames; 21:
   2 images and 2 code-switched region rows);
22-23. the two large fine-tunes at their own sizes from phase 16's ``.th``
   (24 rel-pos tables interpolated 14 -> 24) on lines written over phase
   8's PNGs, one epoch of 2 steps and its eval (``large_ft_phase``): 22
   ``refcoco_grounding_large.yaml`` (384 px, 20 rows a step, 32 an eval
   call, text and cross drop path 0.1, ``careful_hflip``, ``lr_mult`` 2);
   23 ``coco_captioning_large.yaml`` (16 images a step at 40 + 18 = 58
   FG-free tokens, label smoothing 0.1; an eval call of 20 images, 3
   beams, 5 to 50 frames after the prompt; ``vision_lr`` 1e-5, ``text_lr``
   5e-6). Checked: the sizes against the YAML, the import, the optimizer's
   scale of each parameter against the YAML's groups, finite losses and
   metrics, the launches of each step and eval call at 16 heads
   (``large_ft_launches``: the x 584 ones key-tiled; captioning's
   self-attentions on the plain core); each call's CUDA-event and wall
   ms and peak GiB; the state kept in memory for the deferred hold: one
   step on 2 rows in training mode, the attention dropout off and every
   drop path on with the same keep masks injected on both sides
   (``injected_drop_path``), card bf16 against CPU fp32 (losses within
   0.05 + 2%, gradient cosines >= 0.99, each x 584 call within half the
   bf16 rule, grounding's boxes within 0.02).
24. multi-GPU training and remote storage, at world 1 (one card): phase
   7's run (its config, data and seed; one step an epoch) as a user starts
   it on N cards, ``torchrun --standalone --nproc_per_node 1`` (``python -m
   torch.distributed.run`` without a ``torchrun`` script), the rank being
   this script with ``--phase24-child``, which runs
   ``x2vlm_tpu_torch.run.main`` under the process group torchrun describes
   (NCCL) for 2 steps, then ``--resume`` to step 3 with ``--output_hdfs``;
   ``--config`` is an ``hdfs://`` path; a stand-in ``hdfs`` tool the phase
   writes serves both from a local directory. Checked: the group (nccl,
   world 1, rank 0, cuda:0); each call's launches, stream by stream, equal
   to phase 7's call of the same step (step 3's to its step 2's; the
   rank starts while phase 7 runs and waits for it; the gradient all-reduce runs at
   world 1 through NCCL); steps 1 and 2's losses equal to phase 7's bit for
   bit (the first update's lr is 0); the parameters after step 2 against
   phase 7's per family (phase 16's rule: cosine >= 0.9999, relative L2 <=
   1e-3); the resumed run's parameters, AdamW state, step and cursors
   (region included) equal to the saved ones bit for bit; the mirror equal
   to ``output_dir`` byte for byte; each call's CUDA-event ms and peak GiB
   beside phase 7's.

Beside the kernels, phase 1 builds the port's native data plane
(``x2vlm_tpu_torch/csrc_host``, ``g++`` with the libjpeg / libpng
headers): where it builds, each of its pixel ops is held against PIL by
the per-op rules (``data/native.pil_parity_failures``) and every
pretraining phase's streams must take it (``native_aug: auto``); where it
does not, ``native dataplane: unavailable (<the compiler's reason>)`` is
printed on a line of its own and every stream must take PIL. Each
pretraining phase logs the decoder its streams took (``data plane``).

Each launcher phase (7-23) logs its seconds split into data, run,
``--resume``, the CPU fp32 hold, phase 12's export, the state saves and
the rest (``phase N seconds``). The card-against-CPU holds
of phases 9-11 and 13-23 run in
one spawned worker process (its own card context, kernel libraries and
launch counters) beside the later phases; their readings are logged and
their faults failed before the kernels line (``holds collected``).

The 40 x 584 shapes of phases 8 and 9 (the fine-tune's 96-row ITM pass
with dropout, the 1024- and 512-row rerank, grounding's 20-row bbox pass
with probabilities and no multiplier, NLVR2's 16-row passes with dropout,
the 32-row evals) and the 40 x 2312 ones of phase 10 (8 rows with
dropout, 32 rows serving) are held in phase 2 too:
K5 and K6 on the key-tiled walk against their plain version, timed beside
SDPA, with the walk rule and its shared-memory formulas held to Python's
and contract cases of the walk on both routes. So are phase 10's flash
shapes at S=2305 (the step's B=8 forward and backward, the eval's B=32
forward) and its resident tiny shapes (8 x 40 x 40 and 16 x 10 x 40 with
training operands, 4096 x 10 x 40 and 32 x 1 x 40 serving), and phase
11's: K1-K4 at S=577 with B=16 and B=80, key-tiled K5 / K6 at 16 x 25 x
584 and 80 x 46 x 584 with training operands, K5 at 16 x 5, 48 x 2, 80 x
5 and 80 x 2 x 584 serving; and phase 12's: K1-K3 without a bias at S=197
(the CLIP step's B=32, its eval's B=64, the requests' B=128), K5 / K6 at
96 x 40 x 200 and 96 x 40 x 56 with training operands, K5 at 1024 and 512
x 40 x 200 / 56 and 128 x 40 x 56 serving; and phase 13's: K1-K4 at S=197
with B=40 (the video QA step) and B=120 (the video stream), K1 at B=80
(its eval call), K5 / K6 at 8 x 40 x 200, 80 x 40 x 40, 160 x 40 x 40 and
160 x 40 x 200 with training operands, K5 at 16 x 40 x 40 and 16 x 40 x 200
serving; and phase 14's: K5 / K6 with training operands at 32, 96, 128 and
384 x 64 x 64, 32 and 96 x 64 x 200, and 128 and 384 x 64 x 200 with region
key masks; and phase 15's: K5 / K6 at 32 x 10 x 40 with training operands
(xGQA's decoder over a step's answer rows) and K5 at 512 x 10 x 40 serving
(a chunk of its rank pass). At 16 heads (X2VLM-large, ``*_MAIN_SHAPES_16``):
phase 16's K1-K4 at S=197 with B=64 (the image stream) and B=25 (the
region stream's images), K5 / K6 at 128 x 40 x 40, 256 x 40 x 40, 256 x 40
x 200 (region key masks), 64 x 40 x 40 and 64 x 40 x 200 with training
operands; phase 17's K1-K4 at S=2305 with B=8 (a microbatch) and K1 with
B=32 (an eval call), K5 / K6 at 8 x 40 x 40, 32 x 10 x 40 and, key-tiled,
8 x 40 x 2312 with training operands, K5 at 32 x 40 x 40, 32 x 1 x 40,
4096 x 10 x 40 and, key-tiled, 32 x 40 x 2312 serving. Phases 7, 13a, 14
and 18 at 128 images: K1-K4 at S=197, B=128 (12 heads); phase 18's K1-K4 at
B=26 and K5 / K6 with training operands at 256, 128, 512 and 64 x 30 x 30,
128 and 512 x 30 x 200, 256 x 30 x 200 (region key masks) and 64 x 30 x
200; phase 21's K5 / K6 at 30 and 90 x 64 x 64, 90 and 30 x 64 x 200
(region key masks). At 16 heads: K1-K4 at S=197 with B=128 and 50 (phase
19), 32, 14 and 60 (phase 20's images, regions and frames) and 30 (phase
21; its 14 region images are phase 20's), K5 / K6 at 512 x 40 x 40, 512 x
40 x 200 (region key masks), 128 x 40 x 200, 32 x 40 x 40, 32 x 40 x 200,
40 x 40 x 40, 80 x 40 x 40 and 80 x 40 x 200. Phases 22 and 23 at 16 heads:
K1-K4 at S=577 with B=20 (the grounding step; the caption eval's images)
and B=16 (the captioning step), K1 with B=32 (the grounding eval), K5 /
K6 at 20 x 40 x 40 and, key-tiled, 20 x 40 x 584 and 16 x 58 x 584 with
training operands, K5 at 32 x 40 x 584, 20 x 5 x 584 and 60 x 2 x 584
serving.

Every attention launch of phases 3 and 5-24 is counted by kernel, shape,
head count and operands (serving: no multiplier, no probabilities;
training; the flash kernels' with or without a bias) and must fall
on a shape phase 2 checked and timed (``FLASH_MAIN_SHAPES``,
``TINY_MAIN_SHAPES``, ``TILED_MAIN_SHAPES`` and their ``_16``); the
kernels line gives each such shape its launches by path. The holds'
launches (2 rows, 2 images, phase 17's unsplit step) are held by their own
comparisons and not counted there.

Prints the card's name and power limit (``nvidia-smi``), one JSON line of
kernels (with their launches on the main paths), and as its last line
``{"ok": true, "device": {...}}``. ``--profile DIR`` also writes
torch.profiler tables of one round of requests, one int8 round, one train
step and one region-stream call of phase 7 to ``DIR/chip_smoke_profile.txt``,
``DIR/chip_smoke_int8_profile.txt``, ``DIR/chip_smoke_train_profile.txt``
and ``DIR/chip_smoke_region_profile.txt`` (and phase 8's two, and phase
9's ``chip_smoke_{grounding,nlvr}_{step,eval}_profile.txt``, phase
10's ``chip_smoke_vqa_{step,eval}_profile.txt``, phase 11's
``chip_smoke_captioning_{step,eval}_profile.txt`` and phase 12's
``chip_smoke_{clip,swin}_{step,eval}_profile.txt`` and phase 13's
``chip_smoke_video_{pretrain,step,eval}_profile.txt`` and phase 14's
``chip_smoke_cclm_{image,region,mtext}_profile.txt``, the last call of each
stream, and phase 15's ``chip_smoke_iglue_{run}_{step,eval}_profile.txt``,
each run's second step and first eval call, phase 16's
``chip_smoke_large_{image,region}_profile.txt`` and phase 17's
``chip_smoke_large_vqa_{step,eval}_profile.txt``, phases 18-21's
``chip_smoke_phase{N}_{stream}_profile.txt``), each with a
last line of the port kernels' (attention and K7) device time and
launches.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import math
import multiprocessing
import os
import random
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

import torch
import torch.nn.functional as F

from torch.profiler import ProfilerActivity, profile

from x2vlm_tpu_torch.models import XVLMConfig, XVLMForPretrain, XVLMForRetrieval
from x2vlm_tpu_torch.ops import _build
from x2vlm_tpu_torch.ops.flash_attention import (
    BWD_KERNELS, _HEAD_DIMS as FLASH_HEAD_DIMS, _bwd_launchers,
    bwd_smem_bytes as flash_bwd_smem_bytes, dbias_groups, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd, flash_attention_reference, flash_route,
    fwd_smem_bytes as flash_fwd_smem_bytes, typed_lib as flash_typed_lib,
)
from x2vlm_tpu_torch.ops.int8_matmul import (
    GEMM_DESIGN, GEMM_PLAN, gemm_smem_bytes, int8_matmul, int8_matmul_reference, int8_scale,
    quantize_act, quantize_act_reference, typed_lib as int8_typed_lib,
)
from x2vlm_tpu_torch.ops import box as box_ops
from x2vlm_tpu_torch.ops.attention import dot_product_attention
from x2vlm_tpu_torch.ops.quant import quantize_weight
from x2vlm_tpu_torch.ops.tiny_attention import (
    CUDA_CORE, RESIDENT, ROUTE_CODES, TENSOR_CORE, TILED, WALK_CODES,
    bwd_smem_bytes as tiny_bwd_smem_bytes, smem_bytes as tiny_smem_bytes,
    tiled_bwd_smem_bytes as tiny_tiled_bwd_smem_bytes,
    tiled_smem_bytes as tiny_tiled_smem_bytes, tiny_attention_bwd, tiny_attention_bwd_reference,
    tiny_attention_fwd, tiny_attention_reference, tiny_route, tiny_walk, typed_lib,
)
from x2vlm_tpu_torch.core.config import load_config
from x2vlm_tpu_torch.factory import xvlm_config_from_yaml
from x2vlm_tpu_torch.serving import RetrievalServer
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib
from x2vlm_tpu_torch.train import create_optimizer, lr_schedule, make_train_step, param_labels

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak (data sheet)
INT8_OP_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak (data sheet)
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores (data sheet)
BATCH, TEXT_LEN = 128, 40          # serving requests
N_IMG = 197                        # image stream at 224 px; 200 once padded to 8
N_IMG_384 = 577                    # at 384 px (the retrieval fine-tune); 584 once padded
N_IMG_768 = 2305                   # at 768 px (the VQA fine-tune); 2312 once padded
N_IMG_SWIN = 50                    # Swin-B at 224 px: the pooled token + 7 x 7; 56 once padded
RERANK_BATCH = 1024                # ITM rerank rows a call at 384 px: 8 images x k_test 128
# (label, M, K, N, act) of every int8 matmul of the int8 serving path at B=128
INT8_SHAPES = (("vision qkv", BATCH * N_IMG, 768, 2304, None),
               ("vision proj", BATCH * N_IMG, 768, 768, None),
               ("vision fc1", BATCH * N_IMG, 768, 3072, "gelu_fast"),
               ("vision fc2", BATCH * N_IMG, 3072, 768, None),
               ("text q/k/v/out", BATCH * TEXT_LEN, 768, 768, None),
               ("text fc1", BATCH * TEXT_LEN, 768, 3072, "gelu_fast"),
               ("text fc2", BATCH * TEXT_LEN, 3072, 768, None),
               ("fusion cross k/v", BATCH * 200, 768, 768, None))
INT8_REPLACES = "x2vlm_tpu/ops/int8_matmul.py:63"
# the quantize kernel's design, named in its entries of the kernels line (the
# GEMM's is GEMM_DESIGN)
INT8_QUANT_DESIGN = "row_in_registers"
TRAIN_BATCH, N_MASKED = 32, 12     # the pretraining step (bench.py:104-121)
# the shipped fine-tune configs of phase 9: refcoco_grounding_base.yaml's
# batch (its vision pass) and nlvr_base.yaml's (two images a row: its vision
# pass runs 2 x 16 = 32 images); both evaluate at batch 32
GROUNDING_BATCH, NLVR_BATCH, FT_EVAL_BATCH = 20, 16, 32
# the region stream of configs/pretrain/x2vlm_base_4m.yaml: its images a
# batch (max_images) and its region rows (batch_size)
REGION_IMAGES, REGION_ROWS = 50, 128
# vqa2_base.yaml (phase 10): its questions a step, answer rows a step
# (answers_per_batch, 2 x batch_size), answer length, questions an eval call
# and answers reranked a question: the rank pass decodes 32 x 128 rows
VQA_BATCH, VQA_ANSWERS, ANSWER_LEN, VQA_EVAL_BATCH, K_TEST = 8, 16, 10, 32, 128
VQA_RANK_ROWS = VQA_EVAL_BATCH * K_TEST
# coco_captioning_base.yaml (phase 11): images a step and an eval call, caption
# tokens, beams, the longest caption, rollouts an image in SCST; the prompt
# "a picture of " is [CLS] and 3 tokens, so the decode's frame 0 has
# CAP_PROMPT + 1 queries, each later frame 2 (its token and a [MASK]); an
# SCST row holds the prompt and a [MASK] before each of max_length + 1 targets
CAP_BATCH, CAP_TOKENS, CAP_EVAL_BATCH, CAP_BEAMS, CAP_MAX_LEN = 16, 25, 16, 3, 20
CAP_PROMPT, SCST_SAMPLES = 4, 5
# phase 13's video cells at 224 px: vqa_msrvtt_base.yaml's step (8 videos x 5
# frames) and eval call (16 videos x 5), and x2vlm_base_1b_stage2_video.yaml's
# video stream (40 videos x 3 frames)
QA_VIDEOS, QA_FRAMES, QA_EVAL_VIDEOS = 8, 5, 16
STREAM_VIDEOS, STREAM_FRAMES = 40, 3
# phase 14's CCLM cell (cclm_x2vlm_base.yaml): 64-token texts, the
# parallel-text block's pairs a step, XLM-R's vocabulary
CCLM_LEN, PARA_PAIRS, XLMR_VOCAB = 64, 128, 250002
# phase 15's IGLUE cells (configs/finetune/{xvnli,marvl,xgqa,wit,xflickrco}_cclm_base.yaml on
# the Plus base at 384 px): rows a step and an eval call, WIT's and xFlickrCO's text
# length, xGQA's answer rows a step (answers_per_batch, 2 x batch_size) and the rows a
# chunk of its rank pass decodes at XLM-R's vocabulary (models/generation.rank_chunk_rows)
IGLUE_BATCH, IGLUE_EVAL_BATCH, IGLUE_LONG = 16, 32, 80
XGQA_ANSWERS, XGQA_RANK_CHUNK = 2 * IGLUE_BATCH, 512
# phases 16 and 17: X2VLM-large (BEiT-2-large and BERT-large: 16 heads of 64
# everywhere; every other path runs 12); x2vlm_large_4m.yaml's image stream
# (64 images) and region block (64 rows over 25 images); vqa2_large.yaml's
# step of 16 questions in 2 microbatches of 8 (accumulate_steps), each
# microbatch holding the step's 32 answer rows (train/trainer.split_batch),
# its eval calls as vqa2_base.yaml's (32 questions, k_test 128)
BASE_HEADS, LARGE_HEADS = 12, 16
LARGE_BATCH, LARGE_REGION_ROWS, LARGE_REGION_IMAGES = 64, 64, 25
LARGE_VQA_BATCH, LARGE_VQA_ACCUM = 16, 2
LARGE_VQA_MB, LARGE_VQA_ANSWERS = LARGE_VQA_BATCH // LARGE_VQA_ACCUM, 2 * LARGE_VQA_BATCH
SCST_ROWS, SCST_LEN = CAP_BATCH * SCST_SAMPLES, CAP_PROMPT + 2 * (CAP_MAX_LEN + 1)
# the image batch of x2vlm_base_4m.yaml, x2vlm_base_1b_stage2_video.yaml,
# cclm_x2vlm_base.yaml, x2vlm_base_1b.yaml and x2vlm_large_1b.yaml (phases 7,
# 13a, 14, 18, 19 run them at their own sizes)
PRETRAIN_BATCH = 128
# phase 18, x2vlm_base_1b.yaml: 30-token texts, 64 region rows over 26 images
B1B_LEN, B1B_REGION_ROWS, B1B_REGION_IMAGES = 30, 64, 26
# phase 19, x2vlm_large_1b.yaml: 128 region rows over 50 images, a 24-layer
# text stack fusing from layer 18
L1B_REGION_ROWS, L1B_REGION_IMAGES, L1B_TEXT_LAYERS, L1B_FUSION = 128, 50, 24, 18
# phase 20, x2vlm_large_1b_stage2.yaml: 32 images, 32 region rows over 14
# images, 20 clips of 3 frames
S2L_BATCH, S2L_REGION_ROWS, S2L_REGION_IMAGES, S2L_VIDEOS = 32, 32, 14, 20
# phase 21, multilingual_cclm_x2vlm_large.yaml: 30 images, 30 region rows
# over 14 images, 30 parallel pairs; XLM-R of 24 layers (at width 768: the
# JAX factory's preset) and 6 cross layers, BEiT-2-large
CL_BATCH, CL_REGION_IMAGES, CL_TEXT_LAYERS = 30, 14, 24
# phases 22 and 23, X2VLM-large at 384 px: refcoco_grounding_large.yaml's
# step (20 rows) and eval call (32); coco_captioning_large.yaml's FG-free
# step (16 images at 40 + 18 tokens: a [MASK] before each of up to 18
# masked tokens) and eval call (20 images, 3 beams, 50 frames)
LG_BATCH, LG_EVAL_BATCH = 20, 32
LC_BATCH, LC_TOKENS, LC_EVAL_BATCH, LC_MAX_LEN = 16, 58, 20, 50
TINY_REPLACES = {"tiny_attention_fwd": "x2vlm_tpu/ops/tiny_attention.py:88",
                 "tiny_attention_bwd": "x2vlm_tpu/ops/tiny_attention.py:135"}
FLASH_BWD_REPLACES = {"dq": "x2vlm_tpu/ops/flash_attention.py:368",
                      "dkv": "x2vlm_tpu/ops/flash_attention.py:413",
                      "dbias": "x2vlm_tpu/ops/flash_attention.py:480"}

FAILURES = []


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    log(f"FAIL {msg}")


# each launcher phase's seconds by part: "data" (corpora and configs
# written), "run" (the launcher's run), "resume" (its --resume run),
# "hold" (the card bf16 against CPU fp32 hold), "export"; the rest is state
# loads, hashing and model builds around them
PHASE_PARTS = collections.defaultdict(collections.Counter)


def part_done(phase: str, part: str, since: float) -> float:
    """Adds the seconds since ``since`` to ``phase``'s ``part``; returns them."""
    secs = time.perf_counter() - since
    PHASE_PARTS[phase][part] += secs
    return secs


def phase_seconds(phase: str, since: float) -> float:
    """Logs ``phase``'s seconds since ``since`` split into its parts and the
    rest; returns them."""
    total = time.perf_counter() - since
    parts = PHASE_PARTS[phase]
    split = ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
    log(f"phase {phase} seconds: {total:.1f} ({split}{', ' if split else ''}rest "
        f"{total - sum(parts.values()):.1f}); host memory available {host_available_gib()}")
    return total


def host_available_gib():
    """The host's ``MemAvailable`` in GiB (``/dev/shm`` files count against
    it), or None where ``/proc/meminfo`` is not there."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return round(int(line.split()[1]) / 2**20, 1)
    except OSError:
        pass
    return None


# the launcher phases' card-against-CPU holds (phases 9-11, 13-15) run in
# one worker process, spawned, so its card context, kernel libraries, launch
# counters and patched functions are its own: a hold's CPU fp32 pass takes
# minutes of the host's cores and its card pass seconds, and the card's later
# phases go on beside it. ``run`` opens the pool and collects every hold
# before the kernels line; without a pool (a phase called alone) a hold runs
# in place
HOLDS = {"pool": None, "pending": [], "dir": None}


def _hold_worker_init(threads: int) -> None:
    os.nice(10)      # off the critical path: this process's phases come first
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def open_holds(cores: int) -> None:
    """The holds' worker pool, leaving two of ``cores`` to this process's
    host work. Its OpenMP threads sleep between parallel regions
    (``OMP_WAIT_POLICY=PASSIVE``, read when the worker starts) instead of
    spinning on the cores this process's phases run on."""
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    HOLDS["pool"] = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"),
        initializer=_hold_worker_init, initargs=(max(1, cores - 2),))
    # the states deferred holds read, in RAM (the card's machine caps disk writes)
    HOLDS["dir"] = tempfile.mkdtemp(prefix="chip_smoke_holds_",
                                    dir="/dev/shm" if os.path.isdir("/dev/shm") else None)


def close_holds() -> None:
    HOLDS["pool"].shutdown(wait=True, cancel_futures=True)
    shutil.rmtree(HOLDS["dir"], ignore_errors=True)
    HOLDS.update(pool=None, dir=None)


def _timed_hold(fn, *args):
    t = time.perf_counter()
    return (*fn(*args), time.perf_counter() - t)


def defer_hold(label: str, fn, *args) -> None:
    """``fn(*args)`` -> (readings, faults) in the holds' worker; its
    readings are logged and its faults failed under ``label`` by
    ``collect_holds``. A train state goes to ``fn`` as its file's path."""
    if HOLDS["pool"] is None:
        HOLDS["pending"].append((label, None, _timed_hold(fn, *args)))
    else:
        HOLDS["pending"].append((label, HOLDS["pool"].submit(_timed_hold, fn, *args), None))


def collect_holds() -> float:
    """Logs every deferred hold's readings (waiting for the worker) and fails
    its faults; returns the seconds waited."""
    t = time.perf_counter()
    for label, future, done in HOLDS["pending"]:
        r, faults, secs = future.result() if future is not None else done
        log(f"{label}: {json.dumps(r)} ({secs:.1f} s"
            f"{' in the holds worker' if future is not None else ''})")
        for msg in faults:
            fail(f"{label}: {msg}")
    HOLDS["pending"].clear()
    waited = time.perf_counter() - t
    log(f"holds collected: {waited:.1f} s waited for the worker")
    return waited


def params_of(state) -> dict:
    """``state``, or the parameters of the train state saved at that path."""
    return load_params(state) if isinstance(state, str) else state


def hold_state(state: dict, name: str):
    """``state`` saved for a deferred hold (its path), or ``state`` itself
    when holds run in place."""
    if HOLDS["dir"] is None:
        return state
    path = os.path.join(HOLDS["dir"], name)
    torch.save({"params": state}, path)
    return path


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def time_ms(fn, inner: int = 10, reps: int = 7, warmup: int = 2,
            host_ahead: bool = False) -> float:
    """Median over ``reps`` of the per-call device time of ``inner``
    back-to-back calls, from CUDA events. ``host_ahead`` first queues a
    ~10 ms spin on the stream, so the host enqueues the calls before the
    card reaches them and a call shorter than its Python wrapper (or than
    an autograd backward's host work) is timed on the card, not on the
    host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if host_ahead:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rule_bf16(name, kernel_out, plain_bf16_out, truth) -> float:
    """kernel_err <= max(4 x plain_bf16_err, 1e-3 x max|truth|) (the rule
    of tools/verify_kernels.py)."""
    ek = max_err(kernel_out, truth)
    ex = max_err(plain_bf16_out, truth)
    bound = max(4.0 * ex, 1e-3 * max(truth.float().abs().max().item(), 1e-6))
    ok = math.isfinite(ek) and ek <= bound
    log(f"check {name}: kernel_err={ek:.3e} plain_bf16_err={ex:.3e} "
        f"bound={bound:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: kernel error {ek:.3e} above {bound:.3e}")
    return ek


def rule_f32(name, kernel_out, truth) -> float:
    """fp32 kernel against fp32 plain: sums in another order only."""
    ek = max_err(kernel_out, truth)
    bound = 1e-4 * max(truth.float().abs().max().item(), 1.0)
    ok = math.isfinite(ek) and ek <= bound
    log(f"check {name}: kernel_err={ek:.3e} bound={bound:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: kernel error {ek:.3e} above {bound:.3e}")
    return ek


def flash_inputs(gen, dev, B, H, Sq, Skv, D, dtype, bias_shape=None):
    q = torch.randn(B, H, Sq, D, generator=gen, device=dev) * D ** -0.5
    k = torch.randn(B, H, Skv, D, generator=gen, device=dev)
    v = torch.randn(B, H, Skv, D, generator=gen, device=dev)
    bias = None if bias_shape is None else \
        torch.randn(*bias_shape, generator=gen, device=dev)
    cast = lambda t: None if t is None else t.to(dtype)
    return cast(q), cast(k), cast(v), cast(bias)


def tiny_inputs(gen, dev, B, Sq, Skv, H, D, dtype):
    q = torch.randn(B, Sq, H * D, generator=gen, device=dev)
    k = torch.randn(B, Skv, H * D, generator=gen, device=dev)
    v = torch.randn(B, Skv, H * D, generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def as_f32(*ts):
    return [None if t is None else t.float() for t in ts]


def expect_flash_fwd_route(tag, before, dtype, D, n=1) -> None:
    """The flash forward launches since ``before`` were ``n``, all on
    ``flash_route(dtype, D)``."""
    want = {flash_route(dtype, D): n}
    got = route_delta(flash_attention_fwd, before)
    if got != want:
        fail(f"{tag}: flash forward launches by route {got}, expected {want}")


# (B, S, with a backward) of the flash checks, every shape a main path
# launches: serving at B=128, the pretraining step (and phase 7's image
# stream) at B=32 and the region stream at B=50 at 224 px (S=197); at 384 px
# (S=577) the grounding step's B=20, the 32 images of the NLVR2 step, of
# phase 8's fine-tune step and of the grounding eval, and the 64 of the
# NLVR2 eval and of phase 8's eval, phase 11's captioning step, eval call
# and SCST rollouts (B=16) and its SCST step (16 images x 5 rollouts); at
# 768 px (S=2305) phase 10's VQA step (B=8) and eval call (B=32); without a
# bias (CLIP ViT, phase 12) at 224 px: the fine-tune step (B=32), the eval's
# image calls (B=64) and the requests (B=128). (B, S, with a backward, with
# the rel-pos bias)
FLASH_MAIN_SHAPES = ((BATCH, N_IMG, True, True), (TRAIN_BATCH, N_IMG, True, True),
                     (REGION_IMAGES, N_IMG, True, True), (GROUNDING_BATCH, N_IMG_384, True, True),
                     (2 * NLVR_BATCH, N_IMG_384, True, True),
                     (2 * FT_EVAL_BATCH, N_IMG_384, False, True),
                     (CAP_BATCH, N_IMG_384, True, True), (SCST_ROWS, N_IMG_384, True, True),
                     (VQA_BATCH, N_IMG_768, True, True), (VQA_EVAL_BATCH, N_IMG_768, False, True),
                     (TRAIN_BATCH, N_IMG, True, False), (2 * FT_EVAL_BATCH, N_IMG, False, False),
                     (BATCH, N_IMG, False, False),
                     (QA_VIDEOS * QA_FRAMES, N_IMG, True, True),
                     (STREAM_VIDEOS * STREAM_FRAMES, N_IMG, True, True),
                     (QA_EVAL_VIDEOS * QA_FRAMES, N_IMG, False, True),
                     (B1B_REGION_IMAGES, N_IMG, True, True))
# the same at 16 heads (X2VLM-large): phase 16's image stream (B=64) and
# region stream (its 25 images) at 224 px, phase 17's VQA microbatch (B=8)
# and eval call (B=32) at 768 px; phase 19's image stream (B=128, also the
# 12-head pretraining image streams of phases 7, 13a, 14 and 18 above) and
# region stream (50 images), phase 20's image stream (32), its region
# stream and phase 21's (14 images) and its video stream (60 frames),
# phase 21's image stream (30); at 384 px phase 22's grounding step (20
# rows, also phase 23's eval call of 20 images) and eval call (32), phase
# 23's captioning step (16)
FLASH_MAIN_SHAPES_16 = ((LARGE_BATCH, N_IMG, True, True), (LARGE_REGION_IMAGES, N_IMG, True, True),
                        (LARGE_VQA_MB, N_IMG_768, True, True),
                        (VQA_EVAL_BATCH, N_IMG_768, False, True),
                        (PRETRAIN_BATCH, N_IMG, True, True),
                        (L1B_REGION_IMAGES, N_IMG, True, True), (S2L_BATCH, N_IMG, True, True),
                        (S2L_REGION_IMAGES, N_IMG, True, True),
                        (S2L_VIDEOS * STREAM_FRAMES, N_IMG, True, True),
                        (CL_BATCH, N_IMG, True, True),
                        (LG_BATCH, N_IMG_384, True, True), (LC_BATCH, N_IMG_384, True, True),
                        (LG_EVAL_BATCH, N_IMG_384, False, True))


def with_heads(shapes, shapes_16) -> list:
    """(shape, heads) of the checks: ``shapes`` at 12 heads, ``shapes_16`` at 16."""
    return [(s, BASE_HEADS) for s in shapes] + [(s, LARGE_HEADS) for s in shapes_16]


def shape_key(key: tuple, heads: int) -> tuple:
    """A launch's key in the kernels line's ledger: (B, Sq, Skv) at 12 heads,
    (B, Sq, Skv, heads) at any other head count."""
    return key if heads == BASE_HEADS else tuple(key) + (heads,)


def check_flash(gen, dev):
    """K1 at ``FLASH_MAIN_SHAPES`` in bf16 (checked and timed with the card
    ahead of the host, beside SDPA), then over the contract at small shapes
    on both routes. Returns an entry per shape."""
    entries = []
    D = 64
    for (B, S, _, with_bias), H in with_heads(FLASH_MAIN_SHAPES, FLASH_MAIN_SHAPES_16):
        q, k, v, bias = flash_inputs(gen, dev, B, H, S, S, D, torch.bfloat16,
                                     (1, H, S, S) if with_bias else None)
        kind = f"bias(1,{H},{S},{S})" if with_bias else "no bias"
        before = dict(flash_attention_fwd.launches_by_route)
        out, lse = flash_attention_fwd(q, k, v, bias)
        expect_flash_fwd_route(f"flash_attention_fwd B{B} {kind}", before, q.dtype, D)
        p_out, p_lse = flash_attention_reference(q, k, v, bias)
        t_out, t_lse = flash_attention_reference(*as_f32(q, k, v, bias))
        route = flash_route(q.dtype, D)
        err = rule_bf16(f"flash_attention_fwd out B{B} H{H} S{S} D{D} {kind} bf16 "
                        f"({route})", out, p_out, t_out)
        rule_bf16(f"flash_attention_fwd lse B{B} H{H} S{S} D{D} {kind} ({route})", lse, p_lse,
                  t_lse)
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, bias), host_ahead=True)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, bias), inner=2, reps=5,
                           host_ahead=True)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                                scale=1.0), host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(q, k, v, out, bias, lse), 4.0 * B * H * S * S * D)
        entries.append(dict(
            name="flash_attention_fwd", shape=f"B{B} H{H} S{S} D{D} {kind} bf16",
            route="cuda", source="x2vlm_tpu_torch/csrc/flash_attention_fwd.cu",
            replaces="x2vlm_tpu/ops/flash_attention.py:174", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            flash_route=route, key=shape_key((B, S, S), H),
            operands=flash_operands(with_bias)))
        log(f"time flash_attention_fwd B{B} H{H} S{S} {kind}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del q, k, v, bias, out, lse, p_out, p_lse, t_out, t_lse

    # the rest of the contract, at small shapes: bf16 at D = 64 on the
    # tensor cores (D = 128 / 256 on the CUDA cores), fp32 on the CUDA cores
    for name, (B, H, Sq, Skv, D, bias_shape, masked, causal, f32_bias) in {
        "bias(B,H) D128": (3, 2, 150, 150, 128, (3, 2, 150, 150), False, False, False),
        "key_mask+fully_masked_row D64": (3, 2, 130, 130, 64, None, True, False, False),
        "causal bias(1,H) D64": (2, 3, 200, 200, 64, (1, 3, 200, 200), False, True, False),
        "cross Sq100 Skv300 key_mask D64": (2, 2, 100, 300, 64, None, True, False, False),
        "bias(1,1) D256": (2, 2, 70, 129, 256, (1, 1, 70, 129), False, False, False),
        "ragged 130x129 bias(1,H) D64": (2, 3, 130, 129, 64, (1, 3, 130, 129), False, False,
                                         False),
        "bias(B,H) D64": (3, 2, 150, 150, 64, (3, 2, 150, 150), False, False, False),
        "bias(1,1) D64 70x129": (2, 2, 70, 129, 64, (1, 1, 70, 129), False, False, False),
        "fp32 bias(1,H) D64": (2, 2, 197, 197, 64, (1, 2, 197, 197), False, False, True),
        "fp32 bias(1,H) causal key_mask D64 150x160": (2, 2, 150, 160, 64, (1, 2, 150, 160),
                                                       True, True, True),
        "no bias D64": (2, 2, 197, 197, 64, None, False, False, False),
        "197x200 (off every tile) bias(1,H) key_mask D64": (2, 2, 197, 200, 64, (1, 2, 197, 200),
                                                            True, False, False),
        "causal Sq150 Skv100 (rows with no key) D64": (2, 2, 150, 100, 64, None, False, True,
                                                       False),
    }.items():
        km = None
        if masked:
            km = (torch.rand(B, Skv, generator=gen, device=dev) > 0.3).to(torch.int32)
            km[1] = 0
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias = flash_inputs(gen, dev, B, H, Sq, Skv, D, dtype, bias_shape)
            if f32_bias:
                bias = bias.float()
            tag = f"flash_attention_fwd {name} {str(dtype)[6:]} ({flash_route(dtype, D)})"
            before = dict(flash_attention_fwd.launches_by_route)
            out, lse = flash_attention_fwd(q, k, v, bias, km, causal, D ** -0.5)
            expect_flash_fwd_route(tag, before, dtype, D)
            t_out, t_lse = flash_attention_reference(*as_f32(q, k, v, bias), km, causal,
                                                     D ** -0.5)
            # a row with no visible key has lse ~ -1e30 in both; compare the rest
            hide = lambda t: torch.where(t_lse < -1e29, 0.0, t)
            if dtype == torch.bfloat16:
                p_out, p_lse = flash_attention_reference(q, k, v, bias, km, causal, D ** -0.5)
                rule_bf16(tag, out, p_out, t_out)
                rule_bf16(tag + " lse", hide(lse), hide(p_lse), hide(t_lse))
            else:
                rule_f32(tag, out, t_out)
                rule_f32(tag + " lse", hide(lse), hide(t_lse))
            if not bool((lse < -1e29).eq(t_lse < -1e29).all()):
                fail(f"{tag}: the rows with no visible key differ from the plain version's")
    return entries


def tiny_operands(gen, dev, B, Sq, Skv, H, D, dtype, mask, drop):
    """q/k/v, a key mask (None; "pad": the 197 -> 200 pad of the image
    stream, or per-row text lengths when Sq == Skv; "half": row 0's second
    half; "full_row": random, with batch row 1 wholly masked; int32; and
    "region": the region stream's float32 bitmaps over the 197 -> 200 image
    keys) and a dropout multiplier (1/0.9 or 0, in ``dtype``) when
    ``drop``."""
    q, k, v = tiny_inputs(gen, dev, B, Sq, Skv, H, D, dtype)
    km = None
    if mask == "region":
        km = region_bitmaps(gen, dev, B, Skv)
    elif mask == "pad":
        km = torch.ones(B, Skv, dtype=torch.int32, device=dev)
        if Skv in (Sq, TEXT_LEN):   # padded texts (the decoder's: the questions)
            lens = torch.randint(5, Skv + 1, (B,), generator=gen, device=dev)
            km = (torch.arange(Skv, device=dev)[None] < lens[:, None]).to(torch.int32)
        else:   # the 50 -> 56 (197 -> 200, 577 -> 584, 2305 -> 2312) pad of the images
            km[:, min(n for n in (N_IMG_SWIN, N_IMG, N_IMG_384, N_IMG_768)
                      if n + (-n % 8) >= Skv):] = 0
    elif mask == "half":
        km = torch.ones(B, Skv, dtype=torch.int32, device=dev)
        km[0, Skv // 2:] = 0
    elif mask == "full_row":
        km = (torch.rand(B, Skv, generator=gen, device=dev) > 0.3).to(torch.int32)
        km[1] = 0
    dm = None
    if drop:
        keep = torch.rand(B, Sq, H * Skv, generator=gen, device=dev) >= 0.1
        dm = torch.where(keep, 1.0 / 0.9, 0.0).to(dtype)
    return q, k, v, km, dm


def region_bitmaps(gen, dev, B, Skv=N_IMG, side=14):
    """(B, Skv) float32 region bitmaps as ``RegionTextStream`` makes them:
    the CLS slot and a box of 1 x 1 to 8 x 5 patches on the ``side`` x
    ``side`` grid (1 to 40 live patches), every eighth row the whole image
    (a full-image caption row); the keys past the image (the pad to 200)
    off."""
    w = torch.randint(1, 9, (B, 1), generator=gen, device=dev)
    h = torch.randint(1, 6, (B, 1), generator=gen, device=dev)
    x0 = (torch.rand(B, 1, generator=gen, device=dev) * (side - w + 1)).long()
    y0 = (torch.rand(B, 1, generator=gen, device=dev) * (side - h + 1)).long()
    cell = torch.arange(side * side, device=dev)[None]
    col, row = cell % side, cell // side
    inside = (col >= x0) & (col < x0 + w) & (row >= y0) & (row < y0 + h)
    inside[::8] = True
    km = torch.zeros(B, Skv, dtype=torch.float32, device=dev)
    km[:, 0] = 1
    km[:, 1:1 + side * side] = inside.float()
    return km


def route_delta(fn, before) -> dict:
    return {r: n - before.get(r, 0) for r, n in fn.launches_by_route.items()
            if n != before.get(r, 0)}


def expect_route(tag, fn, before, dtype, D) -> None:
    """The launches since ``before`` all took ``tiny_route(dtype, D)``."""
    want = tiny_route(dtype, D)
    got = route_delta(fn, before)
    if set(got) != {want}:
        fail(f"{tag}: launches by route {got}, expected {want} only")


def check_tiny_rules() -> None:
    """The C route rule and each route's shared-memory formulas are the
    Python ones (the dispatch and the wrappers' checks rely on them)."""
    fwd = typed_lib(_build.load("tiny_attention_fwd"))
    bwd = typed_lib(_build.load("tiny_attention_bwd"))
    for dtype in (torch.float32, torch.bfloat16):
        for D in (8, 16, 24, 32, 48, 64, 96, 100, 128, 144, 256):
            want = ROUTE_CODES[tiny_route(dtype, D)]
            for lib in (fwd, bwd):
                got = lib.x2_tiny_attention_route(_build.DTYPE_CODES[dtype], D)
                if got != want:
                    fail(f"tiny route rule: {dtype} D={D}: kernel {got}, python {want}")
    for route, code in ROUTE_CODES.items():
        for Skv, D in ((40, 64), (200, 64), (197, 64), (420, 64), (421, 64), (97, 128),
                       (27, 32), (7, 128), (9, 256), (33, 16), (77, 48), (61, 96), (45, 112)):
            c_bytes = fwd.x2_tiny_attention_smem_bytes(Skv, D, code)
            if c_bytes != tiny_smem_bytes(Skv, D, route):
                fail(f"tiny smem formula ({route}): Skv={Skv} D={D}: kernel {c_bytes}, "
                     f"python {tiny_smem_bytes(Skv, D, route)}")
        for Sq, Skv, D in ((40, 40, 64), (40, 200, 64), (40, 257, 64), (64, 209, 64),
                           (13, 27, 32), (1, 7, 128), (1, 197, 64), (5, 9, 256), (17, 33, 16),
                           (40, 77, 48), (24, 61, 96), (9, 45, 112)):
            c_bytes = bwd.x2_tiny_attention_bwd_smem_bytes(Sq, Skv, D, code)
            if c_bytes != tiny_bwd_smem_bytes(Sq, Skv, D, route):
                fail(f"tiny bwd smem formula ({route}): Sq={Sq} Skv={Skv} D={D}: kernel "
                     f"{c_bytes}, python {tiny_bwd_smem_bytes(Sq, Skv, D, route)}")
        for Sq, D in ((40, 64), (1, 16), (13, 32), (17, 48), (24, 96), (9, 112), (64, 128),
                      (5, 40)):
            for lib, c_fn, py_fn in ((fwd, "x2_tiny_attention_tiled_smem_bytes",
                                      tiny_tiled_smem_bytes),
                                     (bwd, "x2_tiny_attention_bwd_tiled_smem_bytes",
                                      tiny_tiled_bwd_smem_bytes)):
                c_bytes = getattr(lib, c_fn)(Sq, D, code)
                if c_bytes != py_fn(Sq, D, route):
                    fail(f"tiny {c_fn} ({route}): Sq={Sq} D={D}: kernel {c_bytes}, "
                         f"python {py_fn(Sq, D, route)}")
    for Sq in (1, 13, 40, 64, 80):
        for Skv in (40, 200, 257, 258, 420, 421, 584, 1000, 2000):
            for D in (16, 32, 40, 48, 64, 96, 112, 128, 256):
                want = WALK_CODES[tiny_walk(Sq, Skv, D)]
                for lib in (fwd, bwd):
                    got = lib.x2_tiny_attention_walk(Sq, Skv, D)
                    if got != want:
                        fail(f"tiny walk rule: Sq={Sq} Skv={Skv} D={D}: kernel {got}, "
                             f"python {want}")


def tiny_entry(name, shape, key, err, ms, plain_ms, b_ms, b_by, lib_ms, **extra):
    src = "fwd" if name == "tiny_attention_fwd" else "bwd"
    return dict(name=name, shape=shape, route="cuda",
                source=f"x2vlm_tpu_torch/csrc/tiny_attention_{src}.cu",
                replaces=TINY_REPLACES[name], key=key, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                tiny_route=TENSOR_CORE, **extra)


# (label, B, Sq, Skv, training operands, key mask) of the resident tiny
# checks: every 40 x 40 and 40 x 200 shape a main path launches. Serving
# operands (no multiplier, no probabilities): the serving requests at
# B=128, phase 8's eval (its 256 texts a call, the ITM rerank's 1024 and 512
# rows) and phase 9's evals (32 rows). Training operands (a dropout
# multiplier, the probabilities saved): the pretraining step (the text pass
# over 2 x 32 rows, the fusion passes over 4 x 32) and phase 7's text stream
# (32), the region stream (2, 4 and 1 x 128 rows), phase 8's fine-tune step
# (32; ITM 3 x 32) and phase 9's steps (grounding 20, NLVR2 16). Phase 10's
# VQA step: the question's text and fusion self-attention (8 rows) and the
# answer decoder's cross-attention to the 40 question states (16 answer
# rows of 10 tokens); its eval calls: the question's 40 x 40 (32 rows, the
# shape of phase 9's evals), the decoder's first-token pass (32 x 1 x 40)
# and its rank pass (32 x 128 answers of 10 tokens). Phase 12's towers at
# 224 px: the fine-tune's ITM fusion cross-attention (3 x 32 rows) and the
# rerank's (1024 and 512 rows) over CLIP's 200 keys and Swin's 56, and the
# Swin requests' 128 rows. Phase 15's xGQA on the Plus base: the decoder's
# cross-attention over the step's 32 answer rows and over a rank-pass chunk
# of 512 of the eval call's 32 x 128 ranked answers (XLM-R's 250,002-row
# vocabulary); its other shapes are phases 9's and 10's. The pretraining image
# streams at 128 images (phases 7, 13a, 14) take the region stream's
# shapes. Phase 18 (x2vlm_base_1b.yaml, 30-token texts): an aux batch's text
# pass (2 x 128 rows) and ITM + MLM fusion (4 x 128), a noisy batch's text
# pass and its MLM through the whole stack (128 rows), the region stream's
# (2, 4 and 1 x 64 rows). Phase 21 (CCLM-large, XLM-R and the cross encoder
# at 12 heads over 30 images, 30 region rows, 30 parallel pairs)
TINY_MAIN_SHAPES = (
    ("text self-attention", BATCH, TEXT_LEN, TEXT_LEN, False, "pad"),
    ("fusion cross-attention", BATCH, TEXT_LEN, 200, False, "pad"),
    ("retrieval eval text self-attention", 256, TEXT_LEN, TEXT_LEN, False, "pad"),
    ("ITM rerank fusion self-attention", RERANK_BATCH, TEXT_LEN, TEXT_LEN, False, "pad"),
    ("ITM rerank fusion self-attention, texts to images", RERANK_BATCH // 2, TEXT_LEN,
     TEXT_LEN, False, "pad"),
    ("grounding / NLVR2 eval self-attention", FT_EVAL_BATCH, TEXT_LEN, TEXT_LEN, False, "pad"),
    ("fusion self-attention", BATCH, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("fusion cross-attention", BATCH, TEXT_LEN, 200, True, "pad"),
    ("text self-attention, clean and masked rows", 2 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN, True,
     "pad"),
    ("text self-attention", TRAIN_BATCH, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("fine-tune ITM fusion self-attention", 3 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("grounding step self-attention", GROUNDING_BATCH, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("NLVR2 step self-attention", NLVR_BATCH, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("region text self-attention", 2 * REGION_ROWS, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("region fusion self-attention", 4 * REGION_ROWS, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("region fusion cross-attention, region key masks", 4 * REGION_ROWS, TEXT_LEN, 200, True,
     "region"),
    ("VQA step text / fusion self-attention", VQA_BATCH, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("VQA step decoder cross-attention", VQA_ANSWERS, ANSWER_LEN, TEXT_LEN, True, "pad"),
    ("VQA rank decoder cross-attention", VQA_RANK_ROWS, ANSWER_LEN, TEXT_LEN, False, "pad"),
    ("VQA first-token decoder cross-attention", VQA_EVAL_BATCH, 1, TEXT_LEN, False, "pad"),
    ("CLIP fine-tune ITM fusion cross-attention", 3 * TRAIN_BATCH, TEXT_LEN, 200, True, "pad"),
    ("CLIP ITM rerank fusion cross-attention", RERANK_BATCH, TEXT_LEN, 200, False, "pad"),
    ("CLIP ITM rerank fusion cross-attention, texts to images", RERANK_BATCH // 2, TEXT_LEN,
     200, False, "pad"),
    ("Swin fine-tune ITM fusion cross-attention", 3 * TRAIN_BATCH, TEXT_LEN, 56, True, "pad"),
    ("Swin ITM rerank fusion cross-attention", RERANK_BATCH, TEXT_LEN, 56, False, "pad"),
    ("Swin ITM rerank fusion cross-attention, texts to images", RERANK_BATCH // 2, TEXT_LEN,
     56, False, "pad"),
    ("Swin request fusion cross-attention", BATCH, TEXT_LEN, 56, False, "pad"),
    ("video QA step fusion cross-attention", QA_VIDEOS, TEXT_LEN, 200, True, "pad"),
    ("video QA eval text / fusion self-attention", QA_EVAL_VIDEOS, TEXT_LEN, TEXT_LEN, False,
     "pad"),
    ("video QA eval fusion cross-attention", QA_EVAL_VIDEOS, TEXT_LEN, 200, False, "pad"),
    ("video stream text self-attention, clean and masked rows", 2 * STREAM_VIDEOS, TEXT_LEN,
     TEXT_LEN, True, "pad"),
    ("video stream fusion self-attention", 4 * STREAM_VIDEOS, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("video stream fusion cross-attention", 4 * STREAM_VIDEOS, TEXT_LEN, 200, True, "pad"),
    ("CCLM image, region and parallel-text self-attention, TLM cross-attention", REGION_ROWS,
     CCLM_LEN, CCLM_LEN, True, "pad"),
    ("CCLM image / region ITM and TTM self-attention, TTM cross-attention", 3 * REGION_ROWS,
     CCLM_LEN, CCLM_LEN, True, "pad"),
    ("CCLM image / region ITM cross-attention, region key masks", 3 * REGION_ROWS, CCLM_LEN,
     200, True, "region"),
    ("CCLM image / region MLM and bbox cross-attention, region key masks", REGION_ROWS,
     CCLM_LEN, 200, True, "region"),
    ("base 1B text self-attention, clean and masked rows; region ITM + MLM fusion",
     2 * PRETRAIN_BATCH, B1B_LEN, B1B_LEN, True, "pad"),
    ("base 1B noisy MLM text / fusion self-attention; region text pass", PRETRAIN_BATCH,
     B1B_LEN, B1B_LEN, True, "pad"),
    ("base 1B noisy MLM cross-attention", PRETRAIN_BATCH, B1B_LEN, 200, True, "pad"),
    ("base 1B aux ITM + MLM fusion self-attention", 4 * PRETRAIN_BATCH, B1B_LEN, B1B_LEN, True,
     "pad"),
    ("base 1B aux ITM + MLM fusion cross-attention", 4 * PRETRAIN_BATCH, B1B_LEN, 200, True,
     "pad"),
    ("base 1B region ITM + MLM fusion cross-attention, region key masks", 4 * B1B_REGION_ROWS,
     B1B_LEN, 200, True, "region"),
    ("base 1B region bbox self-attention", B1B_REGION_ROWS, B1B_LEN, B1B_LEN, True, "pad"),
    ("base 1B region bbox cross-attention", B1B_REGION_ROWS, B1B_LEN, 200, True, "pad"),
    ("CCLM-large image, region and parallel-text self-attention, TLM cross-attention",
     CL_BATCH, CCLM_LEN, CCLM_LEN, True, "pad"),
    ("CCLM-large ITM and TTM self-attention, TTM cross-attention", 3 * CL_BATCH, CCLM_LEN,
     CCLM_LEN, True, "pad"),
    ("CCLM-large image / region ITM cross-attention, region key masks", 3 * CL_BATCH, CCLM_LEN,
     200, True, "region"),
    ("CCLM-large image / region MLM and bbox cross-attention, region key masks", CL_BATCH,
     CCLM_LEN, 200, True, "region"),
    ("xGQA step decoder cross-attention", XGQA_ANSWERS, ANSWER_LEN, TEXT_LEN, True, "pad"),
    ("xGQA rank decoder cross-attention, a chunk at XLM-R's vocabulary", XGQA_RANK_CHUNK,
     ANSWER_LEN, TEXT_LEN, False, "pad"))
# the same at 16 heads (X2VLM-large). Phase 16's image stream (64 images) and
# region stream (64 rows) share their shapes: the text pass over the clean and
# masked rows (128), the ITM + MLM fusion pass (256; its cross-attention held
# with region key masks, the region stream's), the region stream's bbox pass
# over its 64 rows' full images. Phase 17's VQA microbatch (8 questions; the
# decoder over the step's 32 answer rows) and its eval calls (32 questions,
# the first-token pass, the rank pass over 32 x 128 answers). Phase 19
# (x2vlm_large_1b.yaml) adds the aux batch's and the region stream's ITM +
# MLM fusion over 4 x 128 rows and the noisy batch's MLM (and the region bbox
# pass) over 128; phase 20 (stage-2 large) its region bbox pass (32 rows)
# and video stream (2 and 4 x 20 clips); its image and region fusion run at
# 128 rows. Phase 22's grounding step (20 rows; its eval calls at 32 rows
# share the VQA eval's shape)
TINY_MAIN_SHAPES_16 = (
    ("large text self-attention, clean and masked rows", 2 * LARGE_BATCH, TEXT_LEN, TEXT_LEN,
     True, "pad"),
    ("large ITM + MLM fusion self-attention", 4 * LARGE_BATCH, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("large ITM + MLM fusion cross-attention, region key masks", 4 * LARGE_BATCH, TEXT_LEN,
     200, True, "region"),
    ("large region bbox self-attention", LARGE_REGION_ROWS, TEXT_LEN, TEXT_LEN, True, "pad"),
    ("large region bbox cross-attention", LARGE_REGION_ROWS, TEXT_LEN, 200, True, "pad"),
    ("large VQA microbatch text / fusion self-attention", LARGE_VQA_MB, TEXT_LEN, TEXT_LEN,
     True, "pad"),
    ("large VQA microbatch decoder cross-attention", LARGE_VQA_ANSWERS, ANSWER_LEN, TEXT_LEN,
     True, "pad"),
    ("large VQA eval text / fusion self-attention", VQA_EVAL_BATCH, TEXT_LEN, TEXT_LEN, False,
     "pad"),
    ("large VQA first-token decoder cross-attention", VQA_EVAL_BATCH, 1, TEXT_LEN, False,
     "pad"),
    ("large VQA rank decoder cross-attention", VQA_RANK_ROWS, ANSWER_LEN, TEXT_LEN, False,
     "pad"),
    ("large 1B aux and region ITM + MLM fusion self-attention", 4 * PRETRAIN_BATCH, TEXT_LEN,
     TEXT_LEN, True, "pad"),
    ("large 1B aux and region ITM + MLM fusion cross-attention, region key masks",
     4 * PRETRAIN_BATCH, TEXT_LEN, 200, True, "region"),
    ("large 1B noisy MLM and region bbox cross-attention; stage-2 large fusion", PRETRAIN_BATCH,
     TEXT_LEN, 200, True, "region"),
    ("stage-2 large region bbox self-attention", S2L_REGION_ROWS, TEXT_LEN, TEXT_LEN, True,
     "pad"),
    ("stage-2 large region bbox cross-attention", S2L_REGION_ROWS, TEXT_LEN, 200, True, "pad"),
    ("stage-2 large video text self-attention, clean and masked rows", 2 * S2L_VIDEOS,
     TEXT_LEN, TEXT_LEN, True, "pad"),
    ("stage-2 large video ITM + MLM fusion self-attention", 4 * S2L_VIDEOS, TEXT_LEN, TEXT_LEN,
     True, "pad"),
    ("stage-2 large video ITM + MLM fusion cross-attention", 4 * S2L_VIDEOS, TEXT_LEN, 200,
     True, "pad"),
    ("large grounding step text / fusion self-attention", LG_BATCH, TEXT_LEN, TEXT_LEN, True,
     "pad"))


def check_tiny(gen, dev):
    """K5 at ``TINY_MAIN_SHAPES`` in bf16, each checked and timed, the card
    running ahead of the host; with training operands also checked with the
    probabilities saved and no multiplier (the deterministic passes: the
    region stream's and grounding's bbox pass); then over the contract at
    small shapes on both routes."""
    entries = []
    D = 64
    scale = D ** -0.5
    for (label, B, Sq, Skv, train_ops, mask), H in with_heads(TINY_MAIN_SHAPES,
                                                              TINY_MAIN_SHAPES_16):
        q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, torch.bfloat16,
                                        mask, train_ops)
        ops = ("region_key_mask" if mask == "region" else "key_mask") + \
            (" dropout probs" if train_ops else "")
        tag = f"tiny_attention_fwd {label} B{B} {Sq}x{Skv} H{H} D{D} {ops} bf16"
        err = 0.0
        for mult in ((dm, None) if train_ops else (None,)):
            before = dict(tiny_attention_fwd.launches_by_route)
            out, probs = tiny_attention_fwd(q, k, v, H, km, mult, scale, return_probs=train_ops)
            expect_route(tag, tiny_attention_fwd, before, torch.bfloat16, D)
            p_out, p_probs = tiny_attention_reference(q, k, v, H, km, mult, scale=scale)
            t_out, t_probs = tiny_attention_reference(*as_f32(q, k, v), H, km,
                                                      None if mult is None else mult.float(),
                                                      scale=scale)
            t = tag if mult is not None or not train_ops else tag + ", no multiplier"
            err = max(err, rule_bf16(t, out, p_out, t_out))
            if train_ops:
                err = max(err, rule_bf16(t + " probs", probs, p_probs, t_probs))
        out, probs = tiny_attention_fwd(q, k, v, H, km, dm, scale, return_probs=train_ops)
        ms = time_ms(lambda: tiny_attention_fwd(q, k, v, H, km, dm, scale,
                                                return_probs=train_ops), host_ahead=True)
        plain_ms = time_ms(lambda: tiny_attention_reference(q, k, v, H, km, dm, scale=scale),
                           inner=3, reps=5, host_ahead=True)
        views = [t.view(B, t.shape[1], H, D).transpose(1, 2) for t in (q, k, v)]
        amask = (km != 0)[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *views, attn_mask=amask, scale=scale), host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(q, k, v, out, probs, dm) + km.numel(),
                              4.0 * B * H * Sq * Skv * D)
        log(f"time tiny_attention_fwd {label} B{B} H{H}{' training' if train_ops else ''}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (no dropout, no "
            f"probabilities), bound {b_ms:.4f} ms ({b_by})")
        entries.append(tiny_entry(
            "tiny_attention_fwd", f"B{B} {Sq}x{Skv} H{H} D{D} {ops} bf16",
            shape_key((B, Sq, Skv), H), err, ms, plain_ms, b_ms, b_by, lib_ms,
            operands="training" if train_ops else "serving"))

    # the rest of the contract, at small shapes: bf16 on the tensor cores
    # (D = 256 on the CUDA cores), fp32 on the CUDA cores
    for name, (B, Sq, Skv, H, D, mask) in {
        "non-multiple-of-8 13x27 D32": (3, 13, 27, 4, 32, "half"),
        "no mask 64x420 D64": (2, 64, 420, 2, 64, None),
        "1x7 D128": (2, 1, 7, 3, 128, "half"),
        "fully masked row 40x200 D64": (3, 40, 200, 2, 64, "full_row"),
        "40x197 D64 (Skv off the 16-key tile) fp32 multiplier": (2, 40, 197, 3, 64, "half"),
        "80x50 D64 (two row tiles a warp)": (2, 80, 50, 2, 64, "half"),
        # the other tensor-core head dims: one k-step, odd k-step counts, padded tiles
        "17x33 D16": (2, 17, 33, 3, 16, "half"),
        "40x77 D48": (2, 40, 77, 2, 48, "full_row"),
        "24x61 D96": (2, 24, 61, 2, 96, "half"),
        "9x45 D112": (2, 9, 45, 2, 112, "half"),
        "5x9 D256": (2, 5, 9, 2, 256, "half"),
    }.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, dtype, mask, True)
            dm = torch.where(dm != 0, 1.25, 0.0).to(
                torch.float32 if name.endswith("fp32 multiplier") else dtype)
            before = dict(tiny_attention_fwd.launches_by_route)
            out, probs = tiny_attention_fwd(q, k, v, H, km, dm, scale=D ** -0.5,
                                            return_probs=True)
            # and without the probabilities (on the tensor cores: one walk)
            out1, _ = tiny_attention_fwd(q, k, v, H, km, dm, scale=D ** -0.5)
            tag = f"tiny_attention_fwd {name} {str(dtype)[6:]} ({tiny_route(dtype, D)})"
            expect_route(tag, tiny_attention_fwd, before, dtype, D)
            t_out, t_probs = tiny_attention_reference(*as_f32(q, k, v), H, km, dm.float(),
                                                      scale=D ** -0.5)
            if dtype == torch.bfloat16:
                p_out, p_probs = tiny_attention_reference(q, k, v, H, km, dm,
                                                          scale=D ** -0.5)
                rule_bf16(tag, out, p_out, t_out)
                rule_bf16(tag + " probs", probs, p_probs, t_probs)
                rule_bf16(tag + " without probs", out1, p_out, t_out)
            else:
                rule_f32(tag, out, t_out)
                rule_f32(tag + " probs", probs, t_probs)
                rule_f32(tag + " without probs", out1, t_out)
            if mask == "full_row":   # P = 1 / Skv over the real keys
                uniform = probs.view(B, Sq, H, Skv)[1]
                u_err = (uniform - 1.0 / Skv).abs().max().item()
                if not u_err <= 1e-6 / Skv:
                    fail(f"{tag}: a fully masked row's P is off 1/Skv by {u_err:.3e}")
    return entries


def _sdpa_bwd_ms(q, k, v, mask, dout, scale, host_ahead=False, mask_grad=True):
    """One SDPA forward + autograd.grad, timed on the backward alone: the
    backward of a graph kept with retain_graph. A float mask is a bias whose
    gradient is asked for unless ``mask_grad`` is False (then dq, dk, dv
    only). Returns ms or None with the reason logged (a yardstick only: the
    port never calls SDPA)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    m = mask
    if mask is not None and mask.dtype != torch.bool and mask_grad:
        m = mask.detach().requires_grad_()
        leaves.append(m)
    try:
        with torch.inference_mode(False), torch.enable_grad():
            o = F.scaled_dot_product_attention(*leaves[:3], attn_mask=m, scale=scale)
            return time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
                           inner=5, reps=5, host_ahead=host_ahead)
    except RuntimeError as e:   # no SDPA backend takes these operands
        log(f"sdpa backward not timed: {str(e).splitlines()[0][:200]}")
        return None


def check_flash_bwd_rules() -> None:
    """The C route rule of the four flash kernels, each route's
    shared-memory formulas and the dBias group count are the Python ones."""
    fwd = flash_typed_lib(_build.load("flash_attention_fwd"))
    lib = flash_typed_lib(_build.load("flash_attention_bwd"))
    for dtype in (torch.float32, torch.bfloat16):
        for D in (16, 32, 48, 64, 96, 128, 192, 256):
            want = ROUTE_CODES[flash_route(dtype, D)]
            for which, c_lib in (("fwd", fwd), ("bwd", lib)):
                got = getattr(c_lib, f"x2_flash_attention_{which}_route")(
                    _build.DTYPE_CODES[dtype], D)
                if got != want:
                    fail(f"flash {which} route rule: {dtype} D={D}: kernel {got}, "
                         f"python {want}")

    def py_smem(formula, *args):   # -1, as in C, where the route runs no kernel
        try:
            return formula(*args)
        except ValueError:
            return -1

    for route, code in ROUTE_CODES.items():
        for D in FLASH_HEAD_DIMS:
            for kind in (0, *_build.OPERAND_KINDS.values()):
                c_bytes = fwd.x2_flash_attention_fwd_smem_bytes(D, code, kind)
                py_bytes = py_smem(flash_fwd_smem_bytes, D, route, kind)
                if c_bytes != py_bytes:
                    fail(f"flash fwd smem formula ({route}, bias kind {kind}): D={D}: "
                         f"kernel {c_bytes}, python {py_bytes}")
                for kernel, which in BWD_KERNELS.items():
                    c_bytes = lib.x2_flash_attention_bwd_smem_bytes(which, D, code, kind)
                    py_bytes = py_smem(flash_bwd_smem_bytes, kernel, D, route, kind)
                    if c_bytes != py_bytes:
                        fail(f"flash bwd smem formula ({kernel}, {route}, bias kind {kind}): "
                             f"D={D}: kernel {c_bytes}, python {py_bytes}")
    for B in (1, 2, 3, 7, 32, 128, 1000):
        for tiles in (1, 4, 16, 25, 400):
            for H in (1, 2, 12, 16):
                c_groups = lib.x2_flash_attention_bwd_dbias_groups(B, tiles, H)
                if c_groups != dbias_groups(B, tiles, H):
                    fail(f"dbias groups: B={B} tiles={tiles} H={H}: kernel {c_groups}, "
                         f"python {dbias_groups(B, tiles, H)}")


def flash_bwd_route_delta(before) -> dict:
    now = flash_attention_bwd.launches_by_route
    return {f"{k}/{r}": n - before.get((k, r), 0) for (k, r), n in now.items()
            if n != before.get((k, r), 0)}


def expect_flash_bwd_route(tag, before, dtype, D, with_dbias) -> None:
    """The dQ, dK/dV and (with a bias) dBias launches since ``before`` took
    ``flash_route``, one each."""
    route = flash_route(dtype, D)
    want = {f"dq/{route}": 1, f"dkv/{route}": 1}
    if with_dbias:
        want[f"dbias/{route}"] = 1
    got = flash_bwd_route_delta(before)
    if got != want:
        fail(f"{tag}: launches by route {got}, expected {want}")


def flash_operands(with_bias: bool) -> str:
    """The operands a flash entry of the kernels line holds: with the
    rel-pos bias (every tower but CLIP) or without one."""
    return "bias" if with_bias else "no bias"


def _check_flash_bwd_main(gen, dev, B, S, with_bias=True, H=BASE_HEADS):
    """K2/K3/K4 at (B, H, S, 64) with the shared bias (K2/K3 alone without
    one), bf16: checked against the plain version, dBias bit-identical in
    two launches, timed. Returns their entries."""
    D = 64
    q, k, v, bias = flash_inputs(gen, dev, B, H, S, S, D, torch.bfloat16,
                                 (1, H, S, S) if with_bias else None)
    kind = f"bias(1,{H},{S},{S})" if with_bias else "no bias"
    dout = torch.randn(B, H, S, D, generator=gen, device=dev).to(torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, bias)
    before = dict(flash_attention_bwd.launches_by_route)
    got = flash_attention_bwd(q, k, v, bias, None, out, lse, dout)
    expect_flash_bwd_route(f"flash_attention_bwd B{B} {kind}", before, torch.bfloat16, D,
                           with_bias)
    p_out, p_lse = flash_attention_reference(q, k, v, bias)
    plain = flash_attention_bwd_reference(q, k, v, bias, None, p_out, p_lse, dout)
    tq, tk, tv, tb, tdo = as_f32(q, k, v, bias, dout)
    t_out, t_lse = flash_attention_reference(tq, tk, tv, tb)
    truth = flash_attention_bwd_reference(tq, tk, tv, tb, None, t_out, t_lse, tdo)
    errs = {}
    for label, a, p, t in zip(("dq", "dk", "dv", "dbias"), got, plain, truth):
        if t is not None:
            errs[label] = rule_bf16(f"flash_attention_bwd {label} B{B} H{H} S{S} D{D} "
                                    f"{kind} bf16 ({flash_route(q.dtype, D)})", a, p, t)

    launch = _bwd_launchers(q, k, v, bias, None, out, lse, dout, False, 1.0)
    if with_bias:
        # dBias sums the batch in a fixed order (no atomics): bit-identical run to run
        db1, db2 = launch["dbias"](), launch["dbias"]()
        same = torch.equal(db1, db2)
        log(f"check flash_attention_bwd dbias B{B} H{H} bit-identical across two launches: "
            f"{same}")
        if not same:
            fail(f"flash_attention_bwd dbias B{B} H{H}: two launches differ by "
                 f"{max_err(db1, db2):.3e}")
        del db1, db2
    plain_ms = time_ms(lambda: flash_attention_bwd_reference(q, k, v, bias, None, out, lse,
                                                             dout), inner=2, reps=5,
                       host_ahead=True)
    lib_all = _sdpa_bwd_ms(q, k, v, bias, dout, 1.0, host_ahead=True) if with_bias else None
    lib_qkv = _sdpa_bwd_ms(q, k, v, bias, dout, 1.0, host_ahead=True, mask_grad=False)
    read = nbytes(q, k, v, dout, bias, lse) + lse.numel() * 4   # + delta
    ops = float(B * H * S * S * D)
    shape = f"B{B} H{H} S{S} D{D} {kind} bf16"
    entries, ms_of = [], {}
    kernels = (("flash_attention_bwd_dq", "dq", nbytes(q), 6 * ops, errs["dq"]),
               ("flash_attention_bwd_dkv", "dkv", nbytes(k, v), 8 * ops,
                max(errs["dk"], errs["dv"])))
    if with_bias:
        kernels += (("flash_attention_bwd_dbias", "dbias", H * S * S * 4, 4 * ops,
                     errs["dbias"]),)
    for name, kern, wbytes, flops, err in kernels:
        ms_of[kern] = ms = time_ms(launch[kern], host_ahead=True)
        b_ms, b_by = bound_ms(read + wbytes, flops)
        lib_ms, lib_cover = (lib_all, "dq+dk+dv+dbias") if kern == "dbias" else \
            (lib_qkv, "dq+dk+dv")
        log(f"time {name} B{B} H{H} S{S}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        entries.append(dict(
            name=name, shape=shape, route="cuda",
            source="x2vlm_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=FLASH_BWD_REPLACES[kern], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            plain_and_library_cover=f"plain: dq+dk+dv{'+dbias' if with_bias else ''}; "
                                    f"library: {lib_cover}",
            flash_route=flash_route(q.dtype, D), key=shape_key((B, S, S), H),
            operands=flash_operands(with_bias)))
    fmt = lambda x: x if x is None else round(x, 4)
    log(f"time flash_attention_bwd B{B} H{H} S{S} plain (all three) {plain_ms:.4f} ms, sdpa backward "
        f"dq+dk+dv {fmt(lib_qkv)} ms, dq+dk+dv+dbias {fmt(lib_all)} ms")
    if lib_qkv:
        log(f"flash backward B{B} H{H} S{S} K2 + K3 {ms_of['dq'] + ms_of['dkv']:.4f} ms against sdpa "
            f"backward dq+dk+dv {lib_qkv:.4f} ms: factor "
            f"{(ms_of['dq'] + ms_of['dkv']) / lib_qkv:.3f}")
    return entries


def check_flash_bwd(gen, dev):
    """K2/K3/K4 at the training shapes of ``FLASH_MAIN_SHAPES`` (the
    pretraining step's B=32 and the region stream's B=50 at S=197, the
    fine-tune steps' B=20 and B=32 at S=577) in bf16 (checked and timed with
    the card ahead of the host, beside two SDPA backward yardsticks), then
    over the contract at small shapes on both routes."""
    entries = []
    for (B, S, backward, with_bias), H in with_heads(FLASH_MAIN_SHAPES, FLASH_MAIN_SHAPES_16):
        if backward:
            entries += _check_flash_bwd_main(gen, dev, B, S, with_bias, H)

    # the rest of the contract, at small shapes, with scale = D^-0.5: bf16
    # at D = 64 on the tensor cores (D = 128 / 192 / 256 on the CUDA cores),
    # fp32 on the CUDA cores
    for name, (B, H, Sq, Skv, D, bias_shape, masked, causal, f32_bias) in {
        "bias(B,H) D128": (3, 2, 150, 150, 128, (3, 2, 150, 150), False, False, False),
        "bias(1,1) D256 130x129": (2, 3, 130, 129, 256, (1, 1, 130, 129), False, False, False),
        "key_mask+fully_masked_row D192": (3, 2, 130, 130, 192, None, True, False, False),
        "causal bias(1,H)": (2, 3, 200, 200, 64, (1, 3, 200, 200), False, True, False),
        "cross Sq100 Skv300 key_mask": (2, 2, 100, 300, 64, None, True, False, False),
        "key_mask+fully_masked_row D64": (3, 2, 130, 130, 64, None, True, False, False),
        "ragged 130x129 bias(1,H) D64": (2, 3, 130, 129, 64, (1, 3, 130, 129), False, False,
                                         False),
        "bias(B,H) D64": (3, 2, 150, 150, 64, (3, 2, 150, 150), False, False, False),
        "bias(1,1) D64 70x129": (2, 2, 70, 129, 64, (1, 1, 70, 129), False, False, False),
        "fp32 bias(1,H) D64": (2, 2, 197, 197, 64, (1, 2, 197, 197), False, False, True),
        "fp32 bias(1,H) causal key_mask D64 150x160": (2, 2, 150, 160, 64, (1, 2, 150, 160),
                                                       True, True, True),
        "no bias D64": (2, 2, 197, 197, 64, None, False, False, False),
        "197x200 (off every tile) bias(1,H) key_mask D64": (2, 2, 197, 200, 64, (1, 2, 197, 200),
                                                            True, False, False),
        "causal Sq150 Skv100 (rows with no key) D64": (2, 2, 150, 100, 64, None, False, True,
                                                       False),
    }.items():
        km = None
        if masked:
            km = (torch.rand(B, Skv, generator=gen, device=dev) > 0.3).to(torch.int32)
            km[1] = 0
        sc = D ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias = flash_inputs(gen, dev, B, H, Sq, Skv, D, dtype, bias_shape)
            if f32_bias:
                bias = bias.float()
            dout = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
            out, lse = flash_attention_fwd(q, k, v, bias, km, causal, sc)
            tag = f"flash_attention_bwd {name} {str(dtype)[6:]} ({flash_route(dtype, D)})"
            before = dict(flash_attention_bwd.launches_by_route)
            got = flash_attention_bwd(q, k, v, bias, km, out, lse, dout, causal, sc)
            expect_flash_bwd_route(tag, before, dtype, D, bias is not None)
            tq, tk, tv, tb, tdo = as_f32(q, k, v, bias, dout)
            t_out, t_lse = flash_attention_reference(tq, tk, tv, tb, km, causal, sc)
            truth = flash_attention_bwd_reference(tq, tk, tv, tb, km, t_out, t_lse, tdo,
                                                  causal, sc)
            if dtype == torch.bfloat16:
                p_out, p_lse = flash_attention_reference(q, k, v, bias, km, causal, sc)
                plain = flash_attention_bwd_reference(q, k, v, bias, km, p_out, p_lse,
                                                      dout, causal, sc)
            for i, label in enumerate(("dq", "dk", "dv", "dbias")):
                if truth[i] is None:
                    continue
                if dtype == torch.bfloat16:
                    rule_bf16(f"{tag} {label}", got[i], plain[i], truth[i])
                else:
                    rule_f32(f"{tag} {label}", got[i], truth[i])
    return entries


def check_tiny_bwd(gen, dev):
    """K6 at every training shape of ``TINY_MAIN_SHAPES`` in bf16 with key
    mask and dropout multiplier (checked and timed, the card running ahead
    of the host), also checked without a multiplier (the deterministic
    passes); then over the contract on both routes."""
    entries = []
    D = 64
    scale = D ** -0.5
    for (label, B, Sq, Skv, train_ops, mask), H in with_heads(TINY_MAIN_SHAPES,
                                                              TINY_MAIN_SHAPES_16):
        if not train_ops:
            continue
        q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, torch.bfloat16, mask,
                                        True)
        ops = "region_key_mask" if mask == "region" else "key_mask"
        g = torch.randn(B, Sq, H * D, generator=gen, device=dev).to(torch.bfloat16)
        tag = f"tiny_attention_bwd {{}} {label} B{B} {Sq}x{Skv} H{H} D{D} {ops} dropout bf16"
        err = 0.0
        tq, tk, tv, tg = as_f32(q, k, v, g)
        for mult in (dm, None):
            out, probs = tiny_attention_fwd(q, k, v, H, km, mult, scale, return_probs=True)
            before = dict(tiny_attention_bwd.launches_by_route)
            got = tiny_attention_bwd(q, k, v, probs, mult, g, H, scale, out=out)
            expect_route(f"tiny_attention_bwd {label} B{B}", tiny_attention_bwd, before,
                         torch.bfloat16, D)
            _, p_probs = tiny_attention_reference(q, k, v, H, km, mult, scale)
            plain = tiny_attention_bwd_reference(q, k, v, p_probs, mult, g, H, scale)
            t_mult = None if mult is None else mult.float()
            _, t_probs = tiny_attention_reference(tq, tk, tv, H, km, t_mult, scale)
            truth = tiny_attention_bwd_reference(tq, tk, tv, t_probs, t_mult, tg, H, scale)
            t = tag if mult is not None else tag + ", no multiplier"
            err = max(err, *(rule_bf16(t.format(lab), a, p, tr)
                             for lab, a, p, tr in zip(("dq", "dk", "dv"), got, plain, truth)))
        out, probs = tiny_attention_fwd(q, k, v, H, km, dm, scale, return_probs=True)
        ms = time_ms(lambda: tiny_attention_bwd(q, k, v, probs, dm, g, H, scale, out=out),
                     host_ahead=True)
        plain_ms = time_ms(lambda: tiny_attention_bwd_reference(q, k, v, probs, dm, g, H,
                                                                scale), inner=3, reps=5,
                           host_ahead=True)
        views = [t.view(B, t.shape[1], H, D).transpose(1, 2) for t in (q, k, v)]
        lib_ms = _sdpa_bwd_ms(*views, (km != 0)[:, None, None, :],
                              g.view(B, Sq, H, D).transpose(1, 2), scale, host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(q, k, v, g, probs, dm) + nbytes(q, k, v),
                              8.0 * B * H * Sq * Skv * D)
        log(f"time tiny_attention_bwd {label} B{B} H{H}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa backward {lib_ms} ms, bound {b_ms:.4f} ms ({b_by})")
        entries.append(tiny_entry(
            "tiny_attention_bwd", f"B{B} {Sq}x{Skv} H{H} D{D} {ops} dropout bf16",
            shape_key((B, Sq, Skv), H), err, ms, plain_ms, b_ms, b_by, lib_ms,
            operands="training"))

    for name, (B, Sq, Skv, H, D, mask, drop) in {
        "non-multiple-of-8 13x27 D32": (3, 13, 27, 4, 32, "half", True),
        "no mask 64x209 D64": (2, 64, 209, 2, 64, None, True),
        "1x7 D128 no dropout": (2, 1, 7, 3, 128, "half", False),
        "fully masked row 40x200 D64": (3, 40, 200, 2, 64, "full_row", True),
        "40x197 D64 (Skv off the 16-key tile)": (2, 40, 197, 3, 64, "half", True),
        "40x120 D128 fp32 multiplier": (2, 40, 120, 2, 128, "half", True),
        "80x50 D64 (two row tiles a warp)": (2, 80, 50, 2, 64, "half", True),
        # the other tensor-core head dims: one k-step, odd k-step counts, padded tiles
        "17x33 D16": (2, 17, 33, 3, 16, "half", True),
        "40x77 D48": (2, 40, 77, 2, 48, "full_row", True),
        "24x61 D96 no dropout": (2, 24, 61, 2, 96, "half", False),
        "9x45 D112": (2, 9, 45, 2, 112, "half", True),
        "5x9 D256": (2, 5, 9, 2, 256, "half", True),
    }.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, dtype, mask, drop)
            if dm is not None:
                dm = torch.where(dm != 0, 1.25, 0.0).to(
                    torch.float32 if name.endswith("fp32 multiplier") else dtype)
            g = torch.randn(B, Sq, H * D, generator=gen, device=dev).to(dtype)
            out, probs = tiny_attention_fwd(q, k, v, H, km, dm, D ** -0.5, return_probs=True)
            before = dict(tiny_attention_bwd.launches_by_route)
            got = tiny_attention_bwd(q, k, v, probs, dm, g, H, D ** -0.5, out=out)
            tag = f"tiny_attention_bwd {name} {str(dtype)[6:]} ({tiny_route(dtype, D)})"
            expect_route(tag, tiny_attention_bwd, before, dtype, D)
            tq, tk, tv, tg, tdm = as_f32(q, k, v, g, dm)
            _, t_probs = tiny_attention_reference(tq, tk, tv, H, km, tdm, D ** -0.5)
            truth = tiny_attention_bwd_reference(tq, tk, tv, t_probs, tdm, tg, H, D ** -0.5)
            if dtype == torch.bfloat16:
                _, p_probs = tiny_attention_reference(q, k, v, H, km, dm, D ** -0.5)
                plain = tiny_attention_bwd_reference(q, k, v, p_probs, dm, g, H,
                                                     D ** -0.5)
            for i, label in enumerate(("dq", "dk", "dv")):
                if dtype == torch.bfloat16:
                    rule_bf16(f"{tag} {label}", got[i], plain[i], truth[i])
                else:
                    rule_f32(f"{tag} {label}", got[i], truth[i])
    return entries


# the key-tiled walk's contract cases (B, Sq, Skv, H, D, mask, drop), each
# past the resident shapes: odd Skv and Skv off 4 (rows off 16 bytes),
# fully masked rows, every tensor-core head dim's tile shapes, a head dim
# off 16 (bf16 on the CUDA cores), one query row, 64 query rows; the
# tensor-core kernels' edges: the smallest tiled Skv at 40 rows (a last tile
# of 2 keys), the unpadded 577 image keys (a last tile of 1), one tile past
# the forward's 3-stage ring and past two turns of the backward's 2-stage
# one, 33 and 48 rows (the third row tile partly and wholly filled, one
# warp a row tile),
# and the backward fed the out of a forward with dropout (its row sums)
TILED_CASES = {
    "40x258 D64 (a last tile of 2 keys)": (2, 40, 258, 2, 64, "half", True),
    "40x577 D64 (a last tile of 1 key)": (2, 40, 577, 3, 64, "half", True),
    "64x193 D128 (one tile past the forward's ring)": (2, 64, 193, 2, 128, "half", True),
    "64x257 D64 (one tile past two backward rings)": (2, 64, 257, 2, 64, "full_row", True),
    "33x600 D64 (one row in the third row tile)": (2, 33, 600, 2, 64, "half", True),
    "48x700 D64 (three whole row tiles)": (2, 48, 700, 2, 64, "full_row", True),
    "40x584 D64 out of a forward with dropout": (3, 40, 584, 3, 64, "pad", True),
    "40x584 D64 fully masked row": (2, 40, 584, 2, 64, "full_row", True),
    "40x583 D64 (Skv off 4) fp32 multiplier": (2, 40, 583, 3, 64, "half", True),
    "13x901 D32 (odd Skv)": (2, 13, 901, 2, 32, "half", True),
    "64x1000 D128 no mask": (2, 64, 1000, 2, 128, None, True),
    "1x2000 D16 no dropout": (2, 1, 2000, 2, 16, "half", False),
    "17x700 D48": (2, 17, 700, 2, 48, "full_row", True),
    "24x500 D96": (2, 24, 500, 2, 96, "half", True),
    "9x400 D112 no dropout": (2, 9, 400, 2, 112, "half", False),
    "5x700 D40": (2, 5, 700, 2, 40, "half", True),
}


# (B, Sq, Skv, dropout, probabilities, label) of the key-tiled checks, every
# shape a main path launches. 40 x 584 (384 px): the retrieval fine-tune's
# ITM fusion pass (batch 32: 96 rows, positives and two negatives each),
# the two-stage eval's ITM rerank (8 images x 128 candidate texts; 8 texts x
# the 64 images of phase 8, its most launched); phase 9's grounding bbox
# pass (batch 20, trained without dropout: probabilities saved, no
# multiplier), NLVR2's two fusion passes (batch 16, dropout) and both
# tasks' evals (batch 32); phase 11's captioning step (16 x 25 x 584,
# dropout), its decode (frame 0 at 16 x 5 x 584, then 3 beams x 16 images
# at 2 queries), its SCST rollouts (5 x 16 rows at 5 and 2 queries) and
# SCST step (80 x 46 x 584, dropout). 40 x 2312 (768 px): phase 10's VQA
# question pass (batch 8, dropout) and its eval calls (batch 32)
N_KEYS_384 = N_IMG_384 + (-N_IMG_384 % 8)   # 584: the fusion's padded image stream
N_KEYS_768 = N_IMG_768 + (-N_IMG_768 % 8)   # 2312
TILED_MAIN_SHAPES = (
    (3 * TRAIN_BATCH, TEXT_LEN, N_KEYS_384, True, True, "fine-tune ITM"),
    (RERANK_BATCH, TEXT_LEN, N_KEYS_384, False, False, "ITM rerank"),
    (RERANK_BATCH // 2, TEXT_LEN, N_KEYS_384, False, False, "ITM rerank, texts to images"),
    (GROUNDING_BATCH, TEXT_LEN, N_KEYS_384, False, True, "grounding bbox pass"),
    (NLVR_BATCH, TEXT_LEN, N_KEYS_384, True, True, "NLVR2 fusion"),
    (FT_EVAL_BATCH, TEXT_LEN, N_KEYS_384, False, False, "grounding / NLVR2 eval"),
    (CAP_BATCH, CAP_TOKENS, N_KEYS_384, True, True, "captioning step"),
    (CAP_EVAL_BATCH, CAP_PROMPT + 1, N_KEYS_384, False, False, "caption decode frame 0"),
    (CAP_BEAMS * CAP_EVAL_BATCH, 2, N_KEYS_384, False, False, "caption decode step"),
    (SCST_ROWS, CAP_PROMPT + 1, N_KEYS_384, False, False, "SCST rollout frame 0"),
    (SCST_ROWS, 2, N_KEYS_384, False, False, "SCST rollout step"),
    (SCST_ROWS, SCST_LEN, N_KEYS_384, True, True, "SCST step"),
    (VQA_BATCH, TEXT_LEN, N_KEYS_768, True, True, "VQA question fusion"),
    (VQA_EVAL_BATCH, TEXT_LEN, N_KEYS_768, False, False, "VQA eval question fusion"))
# the same walk at 16 heads: phase 17's VQA microbatch (8 questions) and eval
# call (32); phase 22's grounding step (20 rows) and eval call (32), phase
# 23's FG-free captioning step (16 x 58: the first training shape whose
# rows are no multiple of 8 / 16) and its decode (frame 0 at 20 images,
# then 3 beams x 20 at 2 queries)
TILED_MAIN_SHAPES_16 = (
    (LARGE_VQA_MB, TEXT_LEN, N_KEYS_768, True, True, "large VQA question fusion"),
    (VQA_EVAL_BATCH, TEXT_LEN, N_KEYS_768, False, False, "large VQA eval question fusion"),
    (LG_BATCH, TEXT_LEN, N_KEYS_384, False, True, "large grounding bbox pass"),
    (LG_EVAL_BATCH, TEXT_LEN, N_KEYS_384, False, False, "large grounding eval"),
    (LC_BATCH, LC_TOKENS, N_KEYS_384, True, True, "large captioning FG-free step"),
    (LC_EVAL_BATCH, CAP_PROMPT + 1, N_KEYS_384, False, False, "large caption decode frame 0"),
    (CAP_BEAMS * LC_EVAL_BATCH, 2, N_KEYS_384, False, False, "large caption decode step"))


def walk_delta(fn, before) -> dict:
    return {w: n - before.get(w, 0) for w, n in fn.launches_by_walk.items()
            if n != before.get(w, 0)}


def check_tiny_tiled(gen, dev, shapes, shapes_16=()):
    """K5 and K6 on the key-tiled walk: at the 384 px and 768 px fusion
    cross-attention (Sq x 584, 40 x 2312) at each (B, Sq, Skv, dropout,
    probabilities) of ``shapes`` in bf16, forward and backward, checked and
    timed beside SDPA forward / backward (the card running ahead of the
    host), and at each of ``shapes_16`` at 16 heads; then over the walk's
    contract at small shapes on both routes. Returns the kernels-line
    entries."""
    entries = []
    D = 64
    scale = D ** -0.5
    for (B, Sq, Skv, drop, probs_wanted, label), H in with_heads(shapes, shapes_16):
        q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, torch.bfloat16, "pad",
                                        drop)
        ops = "key_mask dropout" if drop else "key_mask"
        f_before = dict(tiny_attention_fwd.launches_by_walk)
        out, probs = tiny_attention_fwd(q, k, v, H, km, dm, scale, return_probs=True)
        out1, _ = tiny_attention_fwd(q, k, v, H, km, dm, scale)
        if walk_delta(tiny_attention_fwd, f_before) != {TILED: 2}:
            fail(f"tiny_attention_fwd {label}: walks "
                 f"{walk_delta(tiny_attention_fwd, f_before)}, expected 2 tiled")
        p_out, p_probs = tiny_attention_reference(q, k, v, H, km, dm, scale=scale)
        tq, tk, tv, tdm = as_f32(q, k, v, dm)
        t_out, t_probs = tiny_attention_reference(tq, tk, tv, H, km, tdm, scale=scale)
        tag = f"tiny_attention_fwd {label} B{B} {Sq}x{Skv} H{H} D{D} {ops} bf16 (tiled)"
        err = max(rule_bf16(tag, out, p_out, t_out),
                  rule_bf16(tag + " probs", probs, p_probs, t_probs),
                  rule_bf16(tag + " without probs", out1, p_out, t_out))
        ms = time_ms(lambda: tiny_attention_fwd(q, k, v, H, km, dm, scale,
                                                return_probs=probs_wanted), host_ahead=True)
        plain_ms = time_ms(lambda: tiny_attention_reference(q, k, v, H, km, dm, scale=scale),
                           inner=2, reps=3, host_ahead=True)
        views = [t.view(B, t.shape[1], H, D).transpose(1, 2) for t in (q, k, v)]
        amask = (km != 0)[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *views, attn_mask=amask, scale=scale), host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(q, k, v, out, probs if probs_wanted else None, dm)
                              + km.numel(), 4.0 * B * H * Sq * Skv * D)
        log(f"time tiny_attention_fwd {label} (tiled, probabilities {probs_wanted}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (no dropout, no "
            f"probabilities), bound {b_ms:.4f} ms ({b_by})")
        entries.append(tiny_entry(
            "tiny_attention_fwd", f"B{B} {Sq}x{Skv} H{H} D{D} {ops}"
            f"{' probs' if probs_wanted else ''} bf16", shape_key((B, Sq, Skv), H), err, ms,
            plain_ms, b_ms, b_by, lib_ms, tiny_walk=TILED,
            operands="training" if drop or probs_wanted else "serving"))

        g = torch.randn(B, Sq, H * D, generator=gen, device=dev).to(torch.bfloat16)
        b_before = dict(tiny_attention_bwd.launches_by_walk)
        got = tiny_attention_bwd(q, k, v, probs, dm, g, H, scale, out=out)
        if walk_delta(tiny_attention_bwd, b_before) != {TILED: 1}:
            fail(f"tiny_attention_bwd {label}: walks "
                 f"{walk_delta(tiny_attention_bwd, b_before)}, expected 1 tiled")
        plain = tiny_attention_bwd_reference(q, k, v, p_probs, dm, g, H, scale)
        truth = tiny_attention_bwd_reference(tq, tk, tv, t_probs, tdm, g.float(), H, scale)
        tag = f"tiny_attention_bwd {label} B{B} {Sq}x{Skv} H{H} D{D} {ops} bf16 (tiled)"
        err = max(rule_bf16(f"{tag} {lab}", a, p, t)
                  for lab, a, p, t in zip(("dq", "dk", "dv"), got, plain, truth))
        del plain, truth, t_probs, p_probs
        ms = time_ms(lambda: tiny_attention_bwd(q, k, v, probs, dm, g, H, scale, out=out),
                     host_ahead=True)
        plain_ms = time_ms(lambda: tiny_attention_bwd_reference(q, k, v, probs, dm, g, H,
                                                                scale), inner=2, reps=3,
                           host_ahead=True)
        lib_ms = _sdpa_bwd_ms(*views, amask, g.view(B, Sq, H, D).transpose(1, 2), scale,
                              host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(q, k, v, g, probs, dm) + nbytes(q, k, v),
                              8.0 * B * H * Sq * Skv * D)
        log(f"time tiny_attention_bwd {label} (tiled): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa backward {lib_ms} ms, bound {b_ms:.4f} ms ({b_by})")
        entries.append(tiny_entry(
            "tiny_attention_bwd", f"B{B} {Sq}x{Skv} H{H} D{D} {ops} bf16",
            shape_key((B, Sq, Skv), H), err, ms, plain_ms, b_ms, b_by, lib_ms, tiny_walk=TILED,
            operands="training" if drop or probs_wanted else "serving"))
        del q, k, v, km, dm, out, out1, probs, g, got, views
        torch.cuda.empty_cache()

    for name, (B, Sq, Skv, H, D, mask, drop) in TILED_CASES.items():
        if tiny_walk(Sq, Skv, D) != TILED:
            fail(f"tiny tiled case {name}: the rule puts it on the {tiny_walk(Sq, Skv, D)} walk")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, km, dm = tiny_operands(gen, dev, B, Sq, Skv, H, D, dtype, mask, drop)
            if dm is not None:
                dm = torch.where(dm != 0, 1.25, 0.0).to(
                    torch.float32 if name.endswith("fp32 multiplier") else dtype)
            sc = D ** -0.5
            f_before = dict(tiny_attention_fwd.launches_by_route)
            out, probs = tiny_attention_fwd(q, k, v, H, km, dm, sc, return_probs=True)
            out1, _ = tiny_attention_fwd(q, k, v, H, km, dm, sc)
            g = torch.randn(B, Sq, H * D, generator=gen, device=dev).to(dtype)
            b_before = dict(tiny_attention_bwd.launches_by_route)
            got = tiny_attention_bwd(q, k, v, probs, dm, g, H, sc, out=out)
            tag = f"tiny tiled {name} {str(dtype)[6:]} ({tiny_route(dtype, D)})"
            expect_route(tag + " fwd", tiny_attention_fwd, f_before, dtype, D)
            expect_route(tag + " bwd", tiny_attention_bwd, b_before, dtype, D)
            tq, tk, tv, tg, tdm = as_f32(q, k, v, g, dm)
            t_out, t_probs = tiny_attention_reference(tq, tk, tv, H, km, tdm, scale=sc)
            truth = tiny_attention_bwd_reference(tq, tk, tv, t_probs, tdm, tg, H, sc)
            if dtype == torch.bfloat16:
                p_out, p_probs = tiny_attention_reference(q, k, v, H, km, dm, scale=sc)
                plain = tiny_attention_bwd_reference(q, k, v, p_probs, dm, g, H, sc)
                rule_bf16(tag + " out", out, p_out, t_out)
                rule_bf16(tag + " probs", probs, p_probs, t_probs)
                rule_bf16(tag + " out without probs", out1, p_out, t_out)
                for i, lab in enumerate(("dq", "dk", "dv")):
                    rule_bf16(f"{tag} {lab}", got[i], plain[i], truth[i])
            else:
                rule_f32(tag + " out", out, t_out)
                rule_f32(tag + " probs", probs, t_probs)
                rule_f32(tag + " out without probs", out1, t_out)
                for i, lab in enumerate(("dq", "dk", "dv")):
                    rule_f32(f"{tag} {lab}", got[i], truth[i])
            if mask == "full_row":   # P = 1 / Skv over the real keys
                u_err = (probs.view(B, Sq, H, Skv)[1] - 1.0 / Skv).abs().max().item()
                if not u_err <= 1e-6 / Skv:
                    fail(f"{tag}: a fully masked row's P is off 1/Skv by {u_err:.3e}")
    return entries


def int8_inputs(gen, dev, lead, K, N, with_bias=True, dtype=torch.bfloat16):
    """Activations ~ N(0, 1) (a LayerNorm's output), an fp32 weight (N, K)
    ~ N(0, 0.02) quantized per output row, an fp32 bias."""
    x = torch.randn(*lead, K, generator=gen, device=dev).to(dtype)
    w = torch.randn(N, K, generator=gen, device=dev) * 0.02
    bias = torch.randn(N, generator=gen, device=dev) * 0.02 if with_bias else None
    wq, sw = quantize_weight(w)
    return x, w, wq, sw, bias


def rule_int8(name, got, plain, act) -> float:
    """K7 against its plain version: bit-equal without an activation; with
    one, within 1e-6 x max|out| in fp32, and within one bf16 ulp (2^-7 x
    max|out|) in bf16, where an fp32 difference of an ulp in the GELU can
    round the other way."""
    err = max_err(got, plain)
    if act is None:
        bound, ok = 0.0, got.shape == plain.shape and torch.equal(got, plain)
    else:
        scale = plain.float().abs().max().item()
        bound = (1e-6 if got.dtype == torch.float32 else 2.0 ** -7) * scale
        ok = got.shape == plain.shape and math.isfinite(err) and err <= bound
    log(f"check {name}: max_abs_err={err:.3e} bound={bound:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: error {err:.3e} above {bound:.3e} (or shapes differ)")
    return err


def check_quantized(name, xq, sx, x) -> bool:
    p_xq, p_sx = quantize_act_reference(x)
    ok = (xq.shape == p_xq.shape and sx.shape == p_sx.shape
          and torch.equal(xq, p_xq) and torch.equal(sx, p_sx))
    n_diff = int((xq != p_xq).sum()) if xq.shape == p_xq.shape else -1
    log(f"check int8 quantize {name}: xq / sx bit-equal: {ok} ({n_diff} int8 values differ)")
    if not ok:
        fail(f"int8 quantize {name}: (xq, sx) differ from the plain version")
    return ok


def _int_mm_ms(xq, wq):
    """cuBLASLt's int8 product (int32 out, no epilogue) through
    ``torch._int_mm`` on the same operands: a yardstick only, the port
    never calls it. Returns ms or None with the reason logged."""
    try:
        torch._int_mm(xq, wq.t())
        return time_ms(lambda: torch._int_mm(xq, wq.t()), host_ahead=True)
    except RuntimeError as e:
        log(f"torch._int_mm not timed: {str(e).splitlines()[0][:200]}")
        return None


def check_int8_plan() -> None:
    """The GEMM's tile plan and shared memory, fixed in C, are the Python
    mirror's; the ptxas lines of both K7 kernels are logged."""
    lib = int8_typed_lib(_build.load("int8_matmul"))
    c_plan = {k: lib.x2_int8_matmul_plan(i) for i, k in enumerate(GEMM_PLAN)}
    c_smem = lib.x2_int8_matmul_smem_bytes()
    log(f"int8 GEMM plan ({GEMM_DESIGN}): C {json.dumps(c_plan)}, {c_smem} B of shared memory "
        f"a block; python {json.dumps(GEMM_PLAN)}, {gemm_smem_bytes()} B")
    if c_plan != GEMM_PLAN or c_smem != gemm_smem_bytes():
        fail("int8 GEMM plan / shared memory: the C numbers differ from the Python mirror")
    log("ptxas int8 kernels:\n" + "\n".join(
        line for line in _build.ptxas_report("int8_matmul").splitlines()
        if "int8" in line or "quantize" in line or "Used" in line or "spill" in line))


def check_int8(gen, dev):
    """K7 at every shape of the int8 serving path, bf16 in (checked and
    timed), then over the contract at small shapes. Returns the entries of
    the GEMM kernel by (M, K, N) and of the quantize kernel by (M, K)."""
    check_int8_plan()
    gemm_entries, quant_entries = [], {}
    for label, M, K, N, act in INT8_SHAPES:
        x, w, wq, sw, bias = int8_inputs(gen, dev, (M,), K, N)
        xq, sx = quantize_act(x)
        q_ok = check_quantized(f"{label} M{M} K{K}", xq, sx, x)
        errs = []
        for out_dtype in (torch.bfloat16, torch.float32):
            got = int8_matmul(x, wq, sw, bias, act=act, out_dtype=out_dtype, xq=xq, sx=sx)
            plain = int8_matmul_reference(x, wq, sw, bias, act=act, out_dtype=out_dtype,
                                          xq=xq, sx=sx)
            errs.append(rule_int8(f"int8_matmul {label} M{M} K{K} N{N} act={act} "
                                  f"out {str(out_dtype)[6:]}", got, plain, act))
        ms = time_ms(lambda: int8_matmul(x, wq, sw, bias, act=act, xq=xq, sx=sx),
                     host_ahead=True)
        plain_ms = time_ms(lambda: int8_matmul_reference(x, wq, sw, bias, act=act, xq=xq,
                                                         sx=sx), inner=2, reps=5,
                           host_ahead=True)
        lib_ms = _int_mm_ms(xq, wq)
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        lin_ms = time_ms(lambda: F.linear(x, wb, bb), host_ahead=True)
        b_ms, b_by = bound_ms(nbytes(xq, sx, wq, sw, bias) + 2 * M * N, 2.0 * M * N * K,
                              INT8_OP_PER_S)
        log(f"time int8_matmul {label} M{M} K{K} N{N}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch._int_mm {lib_ms} ms, bf16 F.linear {lin_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        gemm_entries.append(dict(
            name="int8_matmul", shape=f"{label} M{M} K{K} N{N} act={act} bf16 out",
            route="cuda", int8_route=GEMM_DESIGN, source="x2vlm_tpu_torch/csrc/int8_matmul.cu",
            replaces=INT8_REPLACES, key=(M, K, N), max_abs_err=max(errs), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="torch._int_mm (int32 product only)", bf16_linear_ms=lin_ms))
        if (M, K) not in quant_entries:
            q_ms = time_ms(lambda: quantize_act(x), host_ahead=True)
            qp_ms = time_ms(lambda: quantize_act_reference(x), inner=3, reps=5,
                            host_ahead=True)
            qb_ms, qb_by = bound_ms(nbytes(x, xq, sx), 4.0 * M * K, FP32_FLOP_PER_S)
            log(f"time int8 quantize M{M} K{K}: kernel {q_ms:.4f} ms, plain {qp_ms:.4f} ms, "
                f"bound {qb_ms:.4f} ms ({qb_by})")
            quant_entries[(M, K)] = dict(
                name="int8_quantize", shape=f"M{M} K{K} bf16", route="cuda",
                int8_route=INT8_QUANT_DESIGN,
                source="x2vlm_tpu_torch/csrc/int8_matmul.cu", replaces=INT8_REPLACES,
                key=(M, K), max_abs_err=0.0 if q_ok else float("nan"), ms=q_ms,
                plain_ms=qp_ms, bound_ms=qb_ms, bound_by=qb_by, library_ms=None)
        del x, w, wq, sw, bias, xq, sx, got, plain

    # the rest of the contract, at small shapes; here the wrapper quantizes
    # x itself (the path without a shared (xq, sx))
    bf, f32 = torch.bfloat16, torch.float32
    for name, (lead, K, N, act, with_bias, in_dt, out_dt) in {
        "M200 bias": ((200,), 768, 768, None, True, bf, bf),
        "M197 gelu_fast fp32 out": ((197,), 768, 3072, "gelu_fast", True, bf, f32),
        "3-D (4, 50) gelu": ((4, 50), 768, 768, "gelu", True, bf, bf),
        "no bias fp32 in and out": ((130,), 3072, 768, None, False, f32, f32),
        "zero rows and an outlier": ((64,), 768, 768, None, True, bf, bf),
        "N77 K784 gelu fp32 out": ((33,), 784, 77, "gelu", True, bf, f32),
        "M1 N130 gelu_fast fp32 in": ((1,), 64, 130, "gelu_fast", True, f32, bf),
        # the 128 x 128 x 128-byte tiles' edges: K = 16 (one K tile, 16 bytes
        # of it read), K one tile plus 16 bytes and six tiles plus 16, M and N
        # one short of and one past a tile, a row of out off 16 bytes (N odd)
        "K16": ((100,), 16, 96, None, True, bf, bf),
        "M127 N129 K144": ((127,), 144, 129, None, True, bf, bf),
        "M129 N127 K912 fp32 out": ((129,), 912, 127, None, True, bf, f32),
        "M255 N257 K784": ((255,), 784, 257, None, False, bf, bf),
        "M257 N255 K16 fp32 in": ((257,), 16, 255, None, True, f32, bf),
        "M256 N256 gelu_fast": ((256,), 768, 256, "gelu_fast", True, bf, bf),
        # 133 x 3 = 399 tiles: 3 waves of 132 blocks and 3 blocks with a fourth tile
        "399 tiles": ((17000,), 768, 384, None, True, bf, bf),
        # 2 x 6 = 12 tiles, fewer than the SMs: one tile a block
        "12 tiles": ((200,), 3072, 768, None, True, bf, bf),
    }.items():
        x, _, wq, sw, bias = int8_inputs(gen, dev, lead, K, N, with_bias, in_dt)
        if name.startswith("zero rows"):
            x[::7] = 0.0
            x[3, 5] = 1000.0
        xq, sx = quantize_act(x)
        check_quantized(name, xq, sx, x)
        got = int8_matmul(x, wq, sw, bias, act=act, out_dtype=out_dt)
        plain = int8_matmul_reference(x, wq, sw, bias, act=act, out_dtype=out_dt)
        rule_int8(f"int8_matmul {name} {tuple(lead)} K{K} N{N} act={act}", got, plain, act)
        if name.startswith("zero rows"):
            zero_ok = bool((xq[::7] == 0).all()) and bool(
                (sx[::7] == int8_scale(torch.zeros((), device=dev))).all())
            if not zero_ok:
                fail("int8 quantize: an all-zero row is not xq = 0, sx = 1e-6 / 127")
    return gemm_entries, list(quant_entries.values())


def reset_counts() -> None:
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches.clear()
    for fn in (flash_attention_fwd, flash_attention_bwd):
        fn.launches_by_route.clear()
        fn.launches_by_shape.clear()
        fn.launches_without_bias.clear()
    for fn in (flash_attention_fwd, flash_attention_bwd, tiny_attention_fwd,
               tiny_attention_bwd):
        fn.launches_by_heads.clear()
    for fn in (tiny_attention_fwd, tiny_attention_bwd, int8_matmul, quantize_act):
        fn.launches = 0
        fn.launches_by_shape.clear()
    for fn in (tiny_attention_fwd, tiny_attention_bwd):
        fn.launches_by_route.clear()
        fn.launches_by_walk.clear()
    dot_product_attention.calls = 0
    dot_product_attention.calls_by_shape.clear()


def train_counts():
    """Launches of every kernel since the last reset: flash by kernel, tiny
    by (B, Sq, Skv); and the ledger's parts (``launch_counts``)."""
    c = launch_counts()
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            **{f"flash_attention_bwd_{k}": flash_attention_bwd.launches[k]
               for k in ("dq", "dkv", "dbias")},
            "tiny_attention_fwd": c["tiny_fwd"], "tiny_attention_bwd": c["tiny_bwd"],
            **{k: c[k] for k in LEDGER_PARTS},
            "tiny_routes": {"tiny_attention_fwd": dict(tiny_attention_fwd.launches_by_route),
                            "tiny_attention_bwd": dict(tiny_attention_bwd.launches_by_route)},
            "flash_fwd_routes": dict(flash_attention_fwd.launches_by_route),
            "flash_bwd_routes": flash_bwd_route_delta({})}


def counts():
    """(flash, tiny, int8 GEMM, int8 quantize) launches since the last reset."""
    return (flash_attention_fwd.launches, tiny_attention_fwd.launches,
            int8_matmul.launches, quantize_act.launches)


def serve(server, images, ids, atts):
    """The main path, one request of each program; the launch counts are
    set to 0 just before each request and read just after it. Returns the
    outputs, the counts of each request and the launches by shape of the
    tiny and the two int8 kernels over the three."""
    per_request = {}
    by_shape = {"tiny": collections.Counter(), "int8_matmul": collections.Counter(),
                "int8_quantize": collections.Counter(), "tiny_route": collections.Counter(),
                "flash_route": collections.Counter(), "flash": collections.Counter()}

    def run(name, fn, *inputs):
        reset_counts()
        out = fn(*inputs)
        torch.cuda.synchronize()
        per_request[name] = counts()
        by_shape["tiny"].update(tiny_attention_fwd.launches_by_shape)
        by_shape["tiny_route"].update(tiny_attention_fwd.launches_by_route)
        by_shape["flash_route"].update(flash_attention_fwd.launches_by_route)
        by_shape["flash"].update(flash_attention_fwd.launches_by_shape)
        by_shape["int8_matmul"].update(int8_matmul.launches_by_shape)
        by_shape["int8_quantize"].update(quantize_act.launches_by_shape)
        return out

    img_embeds, img_feat = run("encode_images", server.encode_images, images)
    txt_embeds, txt_feat = run("encode_texts", server.encode_texts, ids, atts)
    scores = run("itm_score", server.itm_score, img_embeds, txt_embeds, atts)
    return (img_embeds, img_feat, txt_embeds, txt_feat, scores), per_request, by_shape


def want_launches(cfg, quant: bool):
    """(flash, tiny, int8 GEMM, int8 quantize) launches of each request.
    X2VLM-base: 12 BEiT-2 blocks (int8: fused qkv, proj, fc1, fc2, each
    quantizing its input); 12 text layers (q/k/v sharing one quantization,
    out, fc1, fc2); 6 fusion layers with a self- and a cross-attention each
    (q/k/v, out twice, the cross K/V source quantized once, fc1, fc2)."""
    depth, n_text = cfg.vision.depth, cfg.text.fusion_layer
    n_fusion = cfg.text.num_layers - cfg.text.fusion_layer
    q = int(quant)
    return {"encode_images": (depth, 0, 4 * depth * q, 4 * depth * q),
            "encode_texts": (0, n_text, 6 * n_text * q, 4 * n_text * q),
            "itm_score": (0, 2 * n_fusion, 10 * n_fusion * q, 7 * n_fusion * q)}


def check_flash_fwd_routes(tag, routes, n) -> None:
    """The ``n`` K1 launches of a main path all took the tensor-core route."""
    log(f"flash forward launches by route ({tag}): {json.dumps(routes)}")
    if routes != {TENSOR_CORE: n}:
        fail(f"{tag}: flash_attention_fwd launches by route {routes}, expected "
             f"{ {TENSOR_CORE: n} }")


def check_tiny_routes(tag, routes) -> None:
    """Every K5 / K6 launch of a main path took the tensor-core route."""
    log(f"tiny launches by route ({tag}): {json.dumps(routes)}")
    for name, by_route in routes.items():
        if not by_route or set(by_route) != {TENSOR_CORE}:
            fail(f"{tag}: {name} launches by route {by_route}, expected {TENSOR_CORE} only")


def check_round(tag, cfg, outs, per_request, want) -> None:
    """Launches, shapes and finiteness of one round of requests."""
    log(f"launches per request ({tag}; flash, tiny, int8 GEMM, int8 quantize): "
        f"{json.dumps(per_request)}")
    for req, n in want.items():
        if tuple(per_request[req]) != n:
            fail(f"{tag} {req}: launches {per_request[req]}, expected {n}")
    img_embeds, img_feat, txt_embeds, txt_feat, scores = outs
    n_img = cfg.vision.num_patches + 1
    expect_shapes = {"image_embeds": (img_embeds, (BATCH, n_img, cfg.vision.embed_dim)),
                     "image_feat": (img_feat, (BATCH, cfg.embed_dim)),
                     "text_embeds": (txt_embeds, (BATCH, TEXT_LEN, cfg.text.hidden_size)),
                     "text_feat": (txt_feat, (BATCH, cfg.embed_dim)),
                     "itm_score": (scores, (BATCH,))}
    for name, (t, shape) in expect_shapes.items():
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            fail(f"{tag} {name}: shape {tuple(t.shape)} (want {shape}), "
                 f"finite={bool(torch.isfinite(t).all())}")
    log(f"peak device memory of one round of requests ({tag}): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def time_requests(server, requests, outs):
    images, ids, atts = requests
    img_embeds, _, txt_embeds = outs[:3]
    return {
        "encode_images": time_ms(lambda: server.encode_images(images), inner=1, reps=5),
        "encode_texts": time_ms(lambda: server.encode_texts(ids, atts), inner=1, reps=5),
        "itm_score": time_ms(lambda: server.itm_score(img_embeds, txt_embeds, atts),
                             inner=1, reps=5),
    }


# kernel symbols of each wrapper in a profile (tensor-core route first)
KERNEL_NAMES = {"int8_matmul": ("int8_gemm_kernel",),
                "int8_quantize": ("quantize_rows_kernel",),
                "flash_attention_fwd": ("flash_fwd_kernel",),
                "tiny_attention_fwd": ("tc::fwd_kernel", "tiny_fwd_kernel",
                                       "tc::fwd_tiled_kernel", "tiny_fwd_tiled_kernel"),
                "tiny_attention_bwd": ("tc::bwd_kernel", "tiny_bwd_kernel",
                                       "tc::bwd_tiled_kernel", "tiny_bwd_tiled_kernel"),
                "flash_attention_bwd_dq": ("tc::dq_kernel", "flash_bwd_dq_kernel"),
                "flash_attention_bwd_dkv": ("tc::dkv_kernel", "flash_bwd_dkv_kernel"),
                "flash_attention_bwd_dbias": ("tc::dbias_kernel", "tc::dbias_sum_kernel",
                                              "flash_bwd_dbias_kernel")}


def write_profile(args, smi, prof, fname, rows) -> None:
    """The profiler table and the device time of the port's kernels (the
    attention kernels on both routes, K7's two) to ``args.profile/fname``;
    both logged."""
    averages = prof.key_averages()
    kernels = {}
    for e in averages:
        for name, symbols in KERNEL_NAMES.items():
            if any(sym in e.key for sym in symbols):
                t = kernels.setdefault(name, {"device_ms": 0.0, "launches": 0})
                t["device_ms"] += getattr(e, "self_device_time_total",
                                          getattr(e, "self_cuda_time_total", 0.0)) / 1e3
                t["launches"] += e.count
    # the device's busy time: the kernels' and copies' own rows (an operator's
    # row repeats the time of the kernels it launched)
    total = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                for e in averages
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA) / 1e3
    kernels["all device ms"] = round(total, 3)
    tiny_line = f"port kernels in this profile ({fname}): {json.dumps(kernels)}"
    table = averages.table(sort_by="cuda_time_total", row_limit=rows)
    os.makedirs(args.profile, exist_ok=True)
    with open(os.path.join(args.profile, fname), "w") as f:
        f.write(f"{smi}\n{table}\n{tiny_line}\n")
    log(table[:8000])
    log(tiny_line)


def profile_round(args, smi, server, requests, fname) -> None:
    if not args.profile:
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve(server, *requests)
    write_profile(args, smi, prof, fname, 30)


def against_cpu(tag, cfg, cpu_state, outs, requests, n: int = 2) -> None:
    """The same weights on the port's CPU path in fp32 for ``n`` rows:
    feature cosine >= 0.99, ITM error <= 0.05 + 5% of the score scale."""
    images, ids, atts = (t[:n].cpu() for t in requests)
    cpu_model = XVLMForRetrieval(cfg, dtype=torch.float32, device="cpu", seed=None)
    cpu_model.load_state_dict(cpu_state)
    with torch.inference_mode():
        c_img, c_ifeat = cpu_model.encode_images(images)
        c_txt, c_tfeat = cpu_model.encode_texts(ids, atts)
        c_score = cpu_model.itm_score(c_img, c_txt, atts)
    e2e = {}
    for name, card, ref in zip(("image_embeds", "image_feat", "text_embeds", "text_feat",
                                "itm_score"), outs, (c_img, c_ifeat, c_txt, c_tfeat, c_score)):
        card = card[:n].float().cpu()
        e2e[name] = {"max_abs_err": max_err(card, ref),
                     "max_abs_ref": ref.abs().max().item()}
        if name.endswith("feat"):
            e2e[name]["min_cosine"] = F.cosine_similarity(card, ref, dim=-1).min().item()
    log(f"{tag} vs CPU fp32 ({n} rows): {json.dumps(e2e)}")
    for name in ("image_feat", "text_feat"):
        if not e2e[name]["min_cosine"] >= 0.99:
            fail(f"{tag} {name}: cosine to the fp32 CPU path "
                 f"{e2e[name]['min_cosine']:.5f} < 0.99")
    itm = e2e["itm_score"]
    if not itm["max_abs_err"] <= 0.05 + 0.05 * itm["max_abs_ref"]:
        fail(f"{tag} itm_score: error to the fp32 CPU path {itm['max_abs_err']:.4f}")


def int8_phase(args, dev, state, cpu_state, requests, smi):
    """The int8 serving path (bench.py's X2VLM_BENCH=int8 variant: quant_int8
    and the tanh GELU on both towers) with the bf16 phase's weights, beside
    the bf16 model with the same weights and GELU. Returns the launches of
    each int8 request and by shape."""
    base = XVLMConfig.base()

    def variant(quant):
        return dataclasses.replace(
            base, vision=dataclasses.replace(base.vision, act="gelu_fast", quant_int8=quant),
            text=dataclasses.replace(base.text, act="gelu_fast", quant_int8=quant))

    qcfg = variant(True)
    servers = {}
    for tag, cfg in (("int8", qcfg), ("bf16 gelu_fast", variant(False))):
        m = XVLMForRetrieval(cfg, dtype=torch.bfloat16, device=dev, seed=None)
        m.load_state_dict(state)
        servers[tag] = RetrievalServer(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, per_request, by_shape = serve(servers["int8"], *requests)
    check_round("int8", qcfg, outs, per_request, want_launches(qcfg, quant=True))
    check_tiny_routes("int8 serving", {"tiny_attention_fwd": dict(by_shape["tiny_route"])})
    check_flash_fwd_routes("int8 serving", dict(by_shape["flash_route"]), qcfg.vision.depth)

    # int8 against bf16, the same weights and GELU, every row
    f_outs, _, _ = serve(servers["bf16 gelu_fast"], *requests)
    cmp = {name: F.cosine_similarity(outs[i].float(), f_outs[i].float(), dim=-1).min().item()
           for i, name in ((1, "image_feat"), (3, "text_feat"))}
    cmp["itm_max_abs_diff"] = max_err(outs[4], f_outs[4])
    cmp["itm_max_abs_bf16"] = f_outs[4].abs().max().item()
    log(f"card int8 vs card bf16 (same weights, gelu_fast, {BATCH} rows): {json.dumps(cmp)}")
    for name in ("image_feat", "text_feat"):
        if not cmp[name] >= 0.99:
            fail(f"int8 {name}: min cosine to the bf16 path {cmp[name]:.5f} < 0.99")

    # requests timed in turns: int8, bf16, bf16, int8
    times = collections.defaultdict(list)
    for tag in ("int8", "bf16 gelu_fast", "bf16 gelu_fast", "int8"):
        for req, ms in time_requests(servers[tag], requests,
                                     outs if tag == "int8" else f_outs).items():
            times[(tag, req)].append(ms)
    req_ms = {f"{tag} {req}": [round(x, 3) for x in v] for (tag, req), v in times.items()}
    log(f"request ms (B={BATCH}, CUDA events, median of 5 in each of two turns, in the "
        f"order int8, bf16, bf16, int8; both with gelu_fast): {json.dumps(req_ms)}")
    profile_round(args, smi, servers["int8"], requests, "chip_smoke_int8_profile.txt")

    against_cpu("card int8", qcfg, cpu_state, outs, requests)
    del servers, outs, f_outs
    return per_request, by_shape


def train_batch(gen, dev, cfg, B):
    """A pretraining batch as bench.py's: uint8 images, 40-token texts of
    lengths 5-40 (row 0 full), 12 masked positions inside each text."""
    res, V = cfg.vision.image_res, cfg.text.vocab_size
    lens = torch.randint(5, TEXT_LEN + 1, (B,), generator=gen, device=dev)
    lens[0] = TEXT_LEN
    atts = (torch.arange(TEXT_LEN, device=dev)[None] < lens[:, None]).to(torch.int32)
    ids = torch.randint(1, V, (B, TEXT_LEN), generator=gen, device=dev) * atts
    pos = (torch.rand(B, N_MASKED, generator=gen, device=dev) * lens[:, None]).long()
    masked = ids.scatter(1, pos, 103)                       # [MASK]
    return {"image": torch.randint(0, 256, (B, res, res, 3), generator=gen,
                                   device=dev).to(torch.uint8),
            "text_ids": ids, "text_atts": atts, "text_ids_masked": masked,
            "masked_pos": pos, "masked_ids": torch.gather(ids, 1, pos)}


def cosine_params(cfg):
    """Gradients held to the CPU path: through K2/K3 (qkv), K4 (the rel-pos
    table), K6 in a text and a fusion cross-attention layer, the tied MLM
    decoder and ITC."""
    return ("base.vision_encoder.blocks.0.attn.qkv.weight",
            "base.vision_encoder.blocks.0.attn.relative_position_bias_table",
            "base.text_encoder.bert.encoder.layer.0.attention.self.query.weight",
            f"base.text_encoder.bert.encoder.layer.{cfg.text.fusion_layer}"
            ".crossattention.self.key.weight",
            "base.text_encoder.bert.embeddings.word_embeddings.weight",
            "base.temp")


def train_phase(args, dev, gen, smi):
    """The second main path: X2VLM-base pretraining steps (ITC + ITM + MLM,
    AdamW) at B=32 with the config's dropouts on. Returns the launches of
    one step by kernel."""
    cfg = XVLMConfig.base()
    t0 = time.perf_counter()
    model = XVLMForPretrain(cfg, dtype=torch.bfloat16, device=dev, seed=args.seed)
    opt = create_optimizer(model, lr_schedule(1e-4, 1000, 100),
                           labels=param_labels(model.named_parameters(),
                                               cfg.text.fusion_layer))
    step = make_train_step(model, opt)
    batch = train_batch(gen, dev, cfg, TRAIN_BATCH)
    itm_gen = torch.Generator(device=dev)
    itm_gen.manual_seed(args.seed + 1)
    drop_gen = torch.Generator(device=dev)
    drop_gen.manual_seed(args.seed + 2)
    torch.cuda.synchronize()
    log(f"train model: X2VLM-base pretrain, {sum(p.numel() for p in model.parameters())} "
        f"params, built in {time.perf_counter() - t0:.1f} s")

    # the main path: one step, the counts set to 0 just before and read after
    reset_counts()
    metrics = step(batch, itm_gen, drop_gen)
    torch.cuda.synchronize()
    launches = train_counts()
    shown = {k: v if isinstance(v, int) else {str(s): n for s, n in v.items()}
             for k, v in launches.items()}
    log(f"launches per train step: {json.dumps(shown)}")
    n_fusion = cfg.text.num_layers - cfg.text.fusion_layer
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dbias"):
        if launches[name] != cfg.vision.depth:
            fail(f"train step: {name} launched {launches[name]} times, "
                 f"expected {cfg.vision.depth}")
    n_img = cfg.vision.num_patches + 1
    n_img += -n_img % 8                  # the fusion pass pads the image stream
    want_tiny = {(2 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN): cfg.text.fusion_layer,
                 (4 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN): n_fusion,
                 (4 * TRAIN_BATCH, TEXT_LEN, n_img): n_fusion}
    for name in ("tiny_attention_fwd", "tiny_attention_bwd"):
        if dict(launches[name]) != want_tiny:
            fail(f"train step: {name} launches {dict(launches[name])}, expected {want_tiny}")
    check_tiny_routes("train step", launches["tiny_routes"])
    check_flash_fwd_routes("train step", launches["flash_fwd_routes"], cfg.vision.depth)
    want_routes = {f"{k}/{TENSOR_CORE}": cfg.vision.depth for k in ("dq", "dkv", "dbias")}
    if launches["flash_bwd_routes"] != want_routes:
        fail(f"train step: flash backward launches by route {launches['flash_bwd_routes']}, "
             f"expected {want_routes}")
    vals = {k: v.item() for k, v in metrics.items()}
    log(f"train step 1 metrics: {json.dumps(vals)}")
    if not all(math.isfinite(v) for v in vals.values()):
        fail(f"train step: non-finite metrics {vals}")

    # step time: 2 warm-up steps, then the median of 7, CUDA events
    for _ in range(2):
        step(batch, itm_gen, drop_gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(batch, itm_gen, drop_gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(m["loss_total"].item())
    step_ms = statistics.median(times)
    log(f"train step ms (B={TRAIN_BATCH}, CUDA events, median of 7 after 2 warm-up): "
        f"{step_ms:.3f} [{min(times):.3f}-{max(times):.3f}]; samples/s "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss_total per step "
        f"{[round(x, 4) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train steps: non-finite loss_total {losses}")

    if args.profile:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(batch, itm_gen, drop_gen)
            torch.cuda.synchronize()
        write_profile(args, smi, prof, "chip_smoke_train_profile.txt", 40)

    # the same weights, dropout off, B=2, injected negatives: card bf16
    # against the port's CPU fp32 path, losses and gradients
    n = 2
    small = {k: v[:n] for k, v in batch.items()}
    neg = (torch.tensor([1, 0]), torch.tensor([1, 0]))
    cpu_model = XVLMForPretrain(cfg, dtype=torch.float32, device="cpu", seed=None)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    grads, card_losses = {}, {}
    for tag, m, b, ng in (("card", model, small, tuple(t.to(dev) for t in neg)),
                          ("cpu", cpu_model, {k: v.cpu() for k, v in small.items()}, neg)):
        m.eval()
        m.zero_grad(set_to_none=True)
        losses = m(b, neg_idx=ng)
        sum(losses.values()).backward()
        card_losses[tag] = {k: v.item() for k, v in losses.items()}
        params = dict(m.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1)
                      for k in cosine_params(cfg)}
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in cosine_params(cfg)}
    log(f"train card bf16 vs CPU fp32 (B={n}, dropout off, injected negatives): losses "
        f"{json.dumps(card_losses)}; gradient cosine {json.dumps(cos)}")
    for k, c in cos.items():
        if not c >= 0.99:
            fail(f"train gradient {k}: cosine to the fp32 CPU path {c:.5f} < 0.99")
    for k, ref in card_losses["cpu"].items():
        if not abs(card_losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            fail(f"train {k}: card {card_losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    region_hold(model, cpu_model, gen, dev, cfg)
    del model, opt, cpu_model
    torch.cuda.empty_cache()
    return launches


# the region hold's rows: (x, y, w, h) in patches of each row's box, None for
# a full-image caption row; 1 to 40 patches
REGION_HOLD_BOXES = ((0, 0, 1, 1), (3, 4, 2, 2), None, (6, 2, 4, 5), (1, 7, 5, 6),
                     (8, 5, 5, 8))
REGION_HOLD_DEGENERATE = 4          # this row's target box has a negative width


def off_kink_targets(pred: torch.Tensor) -> torch.Tensor:
    """cxcywh box targets for a gradient hold of the L1 + GIoU losses: each
    predicted box grown by fixed margins (left 0.05, top 0.04, right 0.25,
    bottom 0.16 of the image), so that no target coordinate (cx, cy, w, h)
    or edge lies within 0.04 of the prediction's. Both losses have kinks
    where a predicted coordinate or edge meets the target's; a target
    within the card's bf16 rounding (~1e-3 of a box) of one flips a sign of
    the gradient between the card and the CPU path, and the cosine then
    reads that rounding, not the kernels."""
    x0, y0, x1, y1 = box_ops.box_cxcywh_to_xyxy(pred.float()).unbind(-1)
    return box_ops.box_xyxy_to_cxcywh(torch.stack([x0 - 0.05, y0 - 0.04, x1 + 0.25,
                                                   y1 + 0.16], -1))


def region_hold_batch(gen, dev, cfg):
    """A region batch of 2 images and one row per ``REGION_HOLD_BOXES`` entry,
    as ``region_collate`` lays it out: the bitmaps of the boxes, a
    full-image row with ``is_image`` 1, 40-token texts with 12 masked
    positions. ``target_bbox`` is left for ``region_hold`` to set."""
    side = cfg.vision.image_res // cfg.vision.patch_size
    n = len(REGION_HOLD_BOXES)
    grid = torch.zeros(n, side, side)
    for r, b in enumerate(REGION_HOLD_BOXES):
        if b is None:
            grid[r] = 1
            continue
        x, y, w, h = b
        grid[r, y:y + h, x:x + w] = 1
    batch = train_batch(gen, dev, cfg, n)
    return dict(
        batch, image=torch.randn(2, cfg.vision.image_res, cfg.vision.image_res, 3,
                                 generator=gen, device=dev),
        image_atts=torch.cat([torch.ones(n, 1), grid.view(n, -1)], 1).to(dev),
        idx_to_group_img=torch.tensor([0, 1, 0, 1, 0, 1], device=dev),
        target_bbox=torch.zeros(n, 4, device=dev),
        is_image=torch.tensor([float(b is None) for b in REGION_HOLD_BOXES], device=dev))


@torch.no_grad()
def cpu_boxes(cpu_model, head, run) -> torch.Tensor:
    """The boxes ``cpu_model``'s bbox head (``head``) predicts in ``run()``."""
    boxes = []
    hook = head.register_forward_hook(
        lambda mod, inp, out: boxes.append(torch.sigmoid(out.float())))
    try:
        run()
    finally:
        hook.remove()
    return boxes[-1]


def region_cosine_params(cfg):
    """Region-step gradients held to the CPU path: the vision tower (K2/K3,
    K4), a fusion layer's self and cross attention (K6 with region key
    masks), the ITM and bbox heads."""
    f = f"base.text_encoder.bert.encoder.layer.{cfg.text.fusion_layer}"
    return ("base.vision_encoder.blocks.0.attn.qkv.weight",
            "base.vision_encoder.blocks.0.attn.relative_position_bias_table",
            f"{f}.attention.self.query.weight", f"{f}.crossattention.self.key.weight",
            f"{f}.crossattention.self.value.weight", "base.itm_head.0.weight",
            "base.bbox_head.0.weight", "base.bbox_head.3.weight")


# the region hold's injected hard negatives: (image, text) rows of each row
REGION_HOLD_NEG = (torch.tensor([1, 0, 3, 2, 5, 4]), torch.tensor([2, 3, 4, 5, 0, 1]))


def region_masked(km) -> bool:
    """A key mask with a row narrower than the image: a region-masked call."""
    return km is not None and bool(((km != 0).sum(1) < N_IMG).any())


def region_step_grads(m, batch, cfg, ratios=None):
    """One region step of ``m`` on ``batch`` (moved to ``m``'s device),
    dropout off, ``REGION_HOLD_NEG`` injected: its losses and the gradients
    of ``region_cosine_params``; with ``ratios``, each bf16 region-masked
    40 x 200 call into the tiny kernel held (``held_tiny_calls``)."""
    dev = next(m.parameters()).device
    b = {k: v.to(dev) for k, v in batch.items()}
    m.eval()
    m.zero_grad(set_to_none=True)
    with (held_tiny_calls(N_IMG + (-N_IMG % 8), ratios, only=region_masked)
          if ratios is not None else contextlib.nullcontext()):
        out = m(b, neg_idx=tuple(t.to(dev) for t in REGION_HOLD_NEG), ret_bbox_loss=True)
    sum(out.values()).backward()
    params = dict(m.named_parameters())
    return ({k: v.item() for k, v in out.items()},
            {k: params[k].grad.detach().double().cpu().reshape(-1)
             for k in region_cosine_params(cfg)})


def region_boxes(cpu_model, batch) -> torch.Tensor:
    """The boxes the CPU model's bbox head predicts for ``batch``."""
    return cpu_boxes(cpu_model, cpu_model.base.bbox_head, lambda: cpu_model(
        {k: v.cpu() for k, v in batch.items()}, neg_idx=REGION_HOLD_NEG, ret_bbox_loss=True))


def region_hold(model, cpu_model, gen, dev, cfg) -> None:
    """The region step with the weights of ``model``, dropout off and
    injected negatives, card bf16 against the port's CPU fp32 path: the five
    losses within 0.05 + 2%, gradient cosines >= 0.99; and each bf16 call of
    the ITM + MLM fusion pass into the tiny kernel (40 x 200, the region
    bitmaps as key masks) held on the model's operands to the plain version,
    within ``FUSION_CALL_RATIO`` of the bf16 rule's bound. The box targets
    are ``off_kink_targets`` of the CPU path's boxes, one made degenerate
    (``tools/region_kink_witness.py`` reads the hold with targets on and
    off the kinks)."""
    batch = region_hold_batch(gen, dev, cfg)
    cpu_model.eval()
    target = off_kink_targets(region_boxes(cpu_model, batch))
    target[REGION_HOLD_DEGENERATE, 2] *= -1
    batch["target_bbox"] = target.to(dev)
    ratios, grads, losses = [], {}, {}
    n_fusion = cfg.text.num_layers - cfg.text.fusion_layer
    for tag, m in (("card", model), ("cpu", cpu_model)):
        losses[tag], grads[tag] = region_step_grads(m, batch, cfg, ratios)
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in region_cosine_params(cfg)}
    log(f"region card bf16 vs CPU fp32 (2 images, {len(REGION_HOLD_BOXES)} rows, dropout off, "
        f"injected negatives): losses {json.dumps(losses)}; gradient cosine {json.dumps(cos)}; "
        f"held 40 x 200 region-masked calls, error over the bf16 rule's bound "
        f"{[round(x, 3) for x in ratios]}")
    if set(losses["card"]) != {"loss_itc", "loss_itm", "loss_mlm", "loss_bbox", "loss_giou"}:
        fail(f"region step: losses {sorted(losses['card'])}")
    for k, ref in losses["cpu"].items():
        if not abs(losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            fail(f"region {k}: card {losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            fail(f"region gradient {k}: cosine to the fp32 CPU path {c:.5f} < 0.99")
    if len(ratios) != n_fusion or not all(x <= FUSION_CALL_RATIO for x in ratios):
        fail(f"region step: the region-masked 40 x 200 calls' errors over the rule's bound "
             f"{ratios}, expected {n_fusion} at most {FUSION_CALL_RATIO}")


# ---- phases 7 and 8: the launcher's tasks on data written here ----

# the shipped configs phases 7 and 8 start from; they change the data paths
# and what the phases list as cut
PRETRAIN_CONFIG = "configs/pretrain/x2vlm_base_4m.yaml"
RETRIEVAL_CONFIG = "configs/finetune/retrieval_flickr_base.yaml"
SPECIAL_TOKENS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
VOCAB_SIZE = 30522
N_LAUNCH_IMAGES = 64                 # text and region lines of phase 7; images of phase 8
N_PRETRAIN_IMAGES = 2 * PRETRAIN_BATCH   # image-text lines of phase 7: 2 steps' worth
LAUNCH_STEPS = 2                     # phase 7's steps (phase 24 resumes its run)
N_FT_STEPS = 4                       # phase 8: fine-tune steps (128 train captions, B=32)


def write_vocab(root: str, rng: np.random.Generator):
    """A BERT vocab of 30,522 entries: the special tokens at their BERT ids,
    the rest lower-case words and ``##`` pieces drawn from ``rng``. Returns
    the text-encoder directory and the whole words."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    seen, words, pieces = set(SPECIAL_TOKENS.values()), [], []
    n_free = VOCAB_SIZE - len(SPECIAL_TOKENS)
    while len(words) + len(pieces) < n_free:
        tok = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        tok = tok if rng.random() < 0.8 else "##" + tok
        if tok not in seen:
            seen.add(tok)
            (pieces if tok.startswith("##") else words).append(tok)
    free = iter(words + pieces)
    vocab = [SPECIAL_TOKENS.get(i) or next(free) for i in range(VOCAB_SIZE)]
    tok_dir = os.path.join(root, "bert-base-uncased")
    os.makedirs(tok_dir)
    with open(os.path.join(tok_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    return tok_dir, words


def shipped_config(rel: str) -> dict:
    """A config file of the repository, read as the launcher reads it."""
    return load_config(os.path.join(REPO_ROOT, rel)).to_dict()


def random_png(rng: np.random.Generator, side: int) -> bytes:
    """A ``side`` x ``side`` RGB PNG: smooth colour fields and noise."""
    from PIL import Image

    low = rng.integers(0, 256, (side // 32, side // 32, 3)).astype(np.float32)
    img = np.kron(low, np.ones((32, 32, 1), np.float32))
    img = img + rng.normal(0, 12, img.shape)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def caption(rng: np.random.Generator, words, lo: int = 6, hi: int = 30) -> str:
    return " ".join(words[i] for i in rng.integers(0, len(words), int(rng.integers(lo, hi))))


def heads_counts() -> collections.Counter:
    """The attention launches since the last reset by "kernel/heads"."""
    out = collections.Counter()
    for name, fn in (("flash_fwd", flash_attention_fwd), ("tiny_fwd", tiny_attention_fwd),
                     ("tiny_bwd", tiny_attention_bwd)):
        for h, n in fn.launches_by_heads.items():
            out[f"{name}/{h}"] += n
    for (kern, h), n in flash_attention_bwd.launches_by_heads.items():
        out[f"flash_bwd_{kern}/{h}"] += n
    return out


def launch_counts():
    """Every attention launch since the last reset, by kernel, shape, route,
    walk and head count, and the plain attention's calls."""
    return {"flash_fwd": flash_attention_fwd.launches,
            "heads": heads_counts(),
            "flash_fwd_routes": dict(flash_attention_fwd.launches_by_route),
            "flash_bwd": dict(flash_attention_bwd.launches),
            "flash_bwd_routes": flash_bwd_route_delta({}),
            "flash_fwd_shapes": collections.Counter(flash_attention_fwd.launches_by_shape),
            "flash_bwd_shapes": collections.Counter(flash_attention_bwd.launches_by_shape),
            "flash_fwd_nobias": collections.Counter(flash_attention_fwd.launches_without_bias),
            "flash_bwd_nobias": collections.Counter(flash_attention_bwd.launches_without_bias),
            "tiny_fwd": collections.Counter(tiny_attention_fwd.launches_by_shape),
            "tiny_bwd": collections.Counter(tiny_attention_bwd.launches_by_shape),
            "tiny_routes": {"tiny_attention_fwd": dict(tiny_attention_fwd.launches_by_route),
                            "tiny_attention_bwd": dict(tiny_attention_bwd.launches_by_route)},
            "tiny_walks": {"tiny_attention_fwd": dict(tiny_attention_fwd.launches_by_walk),
                           "tiny_attention_bwd": dict(tiny_attention_bwd.launches_by_walk)},
            "plain_attention": dot_product_attention.calls,
            "plain_shapes": collections.Counter(dot_product_attention.calls_by_shape)}


# the parts of ``launch_counts`` the kernels line reads: the tiny launches
# by (B, Sq, Skv), the flash ones by (B, Sq, Skv) and (kernel, B, Sq, Skv),
# and those of them without a bias
LEDGER_PARTS = ("tiny_fwd", "tiny_bwd", "flash_fwd_shapes", "flash_bwd_shapes",
                "flash_fwd_nobias", "flash_bwd_nobias")
# the main paths, as the kernels line's ``launches_by_path`` names them
PATHS = ("serving", "train_step", "int8_serving", "pretrain_launcher", "retrieval_launcher",
         "finetune_launcher", "vqa_launcher", "caption_launcher", "clip_launcher",
         "swin_launcher", "video_launcher", "cclm_launcher", "iglue_launcher",
         "large_pretrain_launcher", "large_vqa_launcher", "base_1b_launcher",
         "large_1b_launcher", "large_stage2_launcher", "cclm_large_launcher",
         "large_grounding_launcher", "large_caption_launcher", "ddp_launcher")


def ledger_add(ledger, path: str, operands: str, c: dict, heads: int = BASE_HEADS) -> None:
    """Adds the attention launches of ``c`` (``LEDGER_PARTS``), all at
    ``heads`` heads, to ``ledger``, a Counter over (path, kernel, operands,
    shape key; ``shape_key``): ``operands`` is
    "serving" or "training" for the tiny forward (its checks differ in them:
    a dropout multiplier, the probabilities saved), "training" for the tiny
    backward; the flash kernels' are "bias" or "no bias" (CLIP ViT)."""
    for key, n in c.get("tiny_fwd", {}).items():
        ledger[(path, "tiny_attention_fwd", operands, shape_key(key, heads))] += n
    for key, n in c.get("tiny_bwd", {}).items():
        ledger[(path, "tiny_attention_bwd", "training", shape_key(key, heads))] += n
    for part, name in (("flash_fwd", lambda key: ("flash_attention_fwd", key)),
                       ("flash_bwd", lambda key: (f"flash_attention_bwd_{key[0]}",
                                                  tuple(key[1:])))):
        nobias = c.get(f"{part}_nobias", {})
        for key, n in c.get(f"{part}_shapes", {}).items():
            kernel, shape = name(key)
            for ops, m in (("bias", n - nobias.get(key, 0)), ("no bias", nobias.get(key, 0))):
                if m:
                    ledger[(path, kernel, ops, shape_key(shape, heads))] += m


def attention_kernels(ledger, checked: list, tiled: list) -> list:
    """The kernels line's attention entries: each of ``checked`` and each of
    ``tiled`` (the 40 x 584 checks) that a main path launched, with its
    launches by path from ``ledger`` at its (kernel, operands, shape). A
    launch in ``ledger`` that no entry holds fails the run."""
    def entry(e):
        e = dict(e)
        key, operands = e.pop("key"), e.pop("operands", None)
        by_path = {p: ledger[(p, e["name"], operands, key)] for p in PATHS}
        return dict(e, launches=sum(by_path.values()), launches_by_path=by_path)

    held = collections.Counter((e["name"], e.get("operands"), e["key"]) for e in checked + tiled)
    for k, n in held.items():
        if n > 1:
            fail(f"{k}: {n} checks would take the same launches")
    for (path, name, operands, key), n in sorted(ledger.items(), key=str):
        if n and (name, operands, key) not in held:
            fail(f"{name}: {n} launches on {path} at {key} ({operands} operands), a shape no "
                 f"check of phase 2 holds")
    kernels = [entry(e) for e in checked]
    for e in map(entry, tiled):
        if e["launches"]:
            kernels.append(e)
        else:
            log(f"{e['name']} {e['shape']}: checked and timed; no main-path launch at this "
                f"shape, so not in the kernels line")
    return kernels


def split_counts(total: dict, train_calls: list) -> dict:
    """``LEDGER_PARTS`` of a launcher run's ``total``, split by operands:
    the launches of its train steps (``train_calls``, each a
    ``counts_delta``) and the rest, its eval."""
    train = {k: sum((collections.Counter(c[k]) for c in train_calls), collections.Counter())
             for k in LEDGER_PARTS}
    return {"training": train,
            "serving": {k: collections.Counter(total[k]) - train[k] for k in LEDGER_PARTS}}


def show_counts(c) -> str:
    return json.dumps({k: ({str(s): n for s, n in v.items()} if isinstance(v, collections.Counter)
                           else v) for k, v in c.items()})


def check_launcher_counts(tag, c, n_flash_fwd, n_flash_bwd, want_tiny, n_plain=0,
                          bwd_kernels=("dq", "dkv", "dbias")) -> None:
    """Every flash launch on the tensor-core route, every tiny launch on the
    tensor-core route and on the walk its shape takes, the plain attention
    ``n_plain`` times (the VQA decoder's causal self-attention, Swin's
    window attention; else never), and the counts expected; the flash
    backward's ``bwd_kernels`` (no dBias without a bias)."""
    log(f"launches ({tag}): {show_counts(c)}")
    if c["plain_attention"] != n_plain:
        fail(f"{tag}: the plain attention ran {c['plain_attention']} times, expected "
             f"{n_plain}")
    if c["flash_fwd"] != n_flash_fwd or \
            c["flash_fwd_routes"] != ({TENSOR_CORE: n_flash_fwd} if n_flash_fwd else {}):
        fail(f"{tag}: flash forward {c['flash_fwd']} launches, routes "
             f"{c['flash_fwd_routes']}, expected {n_flash_fwd} on {TENSOR_CORE}")
    want_bwd = {f"{k}/{TENSOR_CORE}": n_flash_bwd for k in bwd_kernels if n_flash_bwd}
    if c["flash_bwd_routes"] != want_bwd:
        fail(f"{tag}: flash backward routes {c['flash_bwd_routes']}, expected {want_bwd}")
    if any(c["tiny_fwd"].values()) or any(c["tiny_bwd"].values()):
        check_tiny_routes(tag, c["tiny_routes"])
    for name, key in (("tiny_attention_fwd", "tiny_fwd"), ("tiny_attention_bwd", "tiny_bwd")):
        walks = collections.Counter()
        for (b, sq, skv), n in c[key].items():
            walks[tiny_walk(sq, skv, 64)] += n
        if dict(walks) != c["tiny_walks"][name]:
            fail(f"{tag}: {name} walks {c['tiny_walks'][name]}, the shapes' rule gives "
                 f"{dict(walks)}")
        if want_tiny.get(key) is not None and dict(c[key]) != want_tiny[key]:
            fail(f"{tag}: {name} launches {dict(c[key])}, expected {want_tiny[key]}")


def write_region_corpus(path: str, rng: np.random.Generator, words) -> None:
    """``N_LAUNCH_IMAGES`` region lines as the region corpora of the shipped
    config hold them (reference RegionTextJsonDataset): a base64 PNG of 256
    px, 1-6 ``elems`` each with a pixel box ``bb`` = (x, y, w, h) and a
    caption (two for some), some with ``attributes``, some naming "left" or
    "right" (the careful hflip), about half with a full-image ``caption``."""
    side = 256
    with open(path, "w") as f:
        for _ in range(N_LAUNCH_IMAGES):
            elems = []
            for _ in range(int(rng.integers(1, 7))):
                w, h = (int(x) for x in rng.integers(16, side // 2, 2))
                x, y = int(rng.integers(0, side - w)), int(rng.integers(0, side - h))
                cap = caption(rng, words, 2, 10)
                if rng.random() < 0.2:
                    cap += " on the left" if rng.random() < 0.5 else " to the right"
                elem = {"bb": [x, y, w, h],
                        "caption": [cap, caption(rng, words, 2, 10)] if rng.random() < 0.3
                        else cap}
                if rng.random() < 0.3:
                    elem["attributes"] = [caption(rng, words, 1, 3)]
                elems.append(elem)
            line = {"binary": base64.b64encode(random_png(rng, side)).decode(), "elems": elems}
            if rng.random() < 0.5:
                line["caption"] = caption(rng, words)
            f.write(json.dumps(line) + "\n")


def counts_delta(after: dict, before: dict) -> dict:
    """``launch_counts()`` after less before, zero counts dropped."""
    def sub(a, b):
        if isinstance(a, dict):
            out = collections.Counter() if isinstance(a, collections.Counter) else {}
            for k, v in a.items():
                d = sub(v, b.get(k, {} if isinstance(v, dict) else 0))
                if d or isinstance(v, dict):
                    out[k] = d
            return out
        return a - b

    return {k: sub(v, before[k]) for k, v in after.items()}


def region_step_launches(n_fusion: int = 6, n_text: int = 12) -> dict:
    """The tiny launches of one region-stream step (forward and backward
    alike): the text pass over the clean and masked rows, the ITM + MLM
    fusion pass over 4 x 128 rows (region key masks) and the bbox pass over
    the 128 rows' full images."""
    R = REGION_ROWS
    return {(2 * R, TEXT_LEN, TEXT_LEN): n_text, (4 * R, TEXT_LEN, TEXT_LEN): n_fusion,
            (4 * R, TEXT_LEN, 200): n_fusion, (R, TEXT_LEN, TEXT_LEN): n_fusion,
            (R, TEXT_LEN, 200): n_fusion}


class StreamTimer:
    """Wraps the pretraining loop's per-stream grad functions and its
    optimizer step (``tasks.pretrain.make_grad_fn`` / ``make_apply_grads``):
    each call's CUDA-event ms, wall ms and peak device memory by stream, its
    launches, its losses and its matching-loss flag (``itm``; None for the text
    streams). With ``profile_call`` (stream,
    index), or a set of them, those calls run under torch.profiler, written
    to ``profile_to`` (args, smi, file name; a ``{stream}`` in the name
    takes the stream's)."""

    def __init__(self, profile_call=None, profile_to=None):
        from x2vlm_tpu_torch.tasks import pretrain as pretrain_mod

        self.mod = pretrain_mod
        self.calls = collections.defaultdict(list)
        self.profile_calls = (set(profile_call) if isinstance(profile_call, (set, frozenset))
                              else {profile_call})
        self.profile_to = profile_to

    def _timed(self, stream, fn, itm=None):
        def call(*a):
            record = {"itm": itm}
            # the video stream shares the image stream's grad function, the
            # parallel text (its pairs' second texts) the text stream's signature
            name = ("video" if stream == "image" and a[0]["image"].dim() == 5 else
                    "mtext" if a and "text_ids_2" in a[0] else stream)
            last = (name, len(self.calls[name])) in self.profile_calls
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = launch_counts()
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as prof:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                start.record()
                out = fn(*a)
                end.record()
                end.synchronize()
            record.update(ms=start.elapsed_time(end), wall_ms=(time.perf_counter() - t) * 1e3,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          launches=counts_delta(launch_counts(), before),
                          losses=({k: v.item() for k, v in out.items()}
                                  if isinstance(out, dict) else None))
            self.calls[name].append(record)
            if last:
                args, smi, fname = self.profile_to
                write_profile(args, smi, prof, fname.format(stream=name), 40)
            return out

        return call

    def __enter__(self):
        self.orig = self.mod.make_grad_fn, self.mod.make_apply_grads

        def make_grad_fn(model, **kw):
            apply = kw.get("apply_kwargs") or {}
            stream = ("region" if apply.get("ret_bbox_loss") else
                      "image" if "ret_match_loss" in apply else "text")
            return self._timed(stream, self.orig[0](model, **kw), apply.get("ret_match_loss"))

        self.mod.make_grad_fn = make_grad_fn
        self.mod.make_apply_grads = lambda opt: self._timed("apply", self.orig[1](opt))
        return self

    def __exit__(self, *exc):
        self.mod.make_grad_fn, self.mod.make_apply_grads = self.orig

    def summary(self) -> dict:
        """Median ms, wall ms and the largest peak GiB of each stream's calls,
        and the region stream's share of the step."""
        out = {k: {"calls": len(v), "ms": statistics.median(r["ms"] for r in v),
                   "wall_ms": statistics.median(r["wall_ms"] for r in v),
                   "peak_gib": max(r["peak_gib"] for r in v)}
               for k, v in self.calls.items()}
        step_ms = sum(x["ms"] for x in out.values())
        step_wall = sum(x["wall_ms"] for x in out.values())
        if "region" in out and step_ms:
            out["region_share"] = {"ms": out["region"]["ms"] / step_ms,
                                   "wall_ms": out["region"]["wall_ms"] / step_wall}
        return out


NATIVE = {"available": None}   # the native data plane on this host: set by _run


def check_data_plane(tag: str, record: dict) -> None:
    """Log the decoder each stream of a launcher pretraining run took (its
    record's ``data_plane``) and hold it to ``native_aug: auto``: every
    stream on the native data plane where this host built it, every stream
    on PIL where it did not."""
    planes = dict(record.get("data_plane") or {})
    want = "native" if NATIVE["available"] else "pil"
    log(f"{tag} data plane: {json.dumps(planes)}")
    if not planes or set(planes.values()) != {want}:
        fail(f"{tag}: the streams took {planes}; native_aug: auto on this host gives {want}")


PHASE7 = {}   # phase 7's config, its calls (StreamTimer) and its parameters after step 2


def write_pretrain_data(root: str, seed: int) -> dict:
    """Phase 7's data and config under ``root`` (written while the kernels
    build): the vocab, the image, region and text lines, the shipped config
    pointed at them. Returns the tokenizer directory, the words, the config,
    its path and the seconds taken."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 7)
    tok_dir, words = write_vocab(root, rng)
    img_file, txt_file = os.path.join(root, "images.jsonl"), os.path.join(root, "texts.jsonl")
    region_file = os.path.join(root, "regions.jsonl")
    with open(img_file, "w") as f:
        for _ in range(N_PRETRAIN_IMAGES):
            f.write(json.dumps({"binary": base64.b64encode(random_png(rng, 256)).decode(),
                                "desc": caption(rng, words)}) + "\n")
    with open(txt_file, "w") as f:
        for _ in range(N_LAUNCH_IMAGES):
            f.write(json.dumps({"text": caption(rng, words, 10, 45)}) + "\n")
    write_region_corpus(region_file, rng, words)
    shipped = shipped_config(PRETRAIN_CONFIG)
    cfg = dict(shipped)
    # the image and region blocks as shipped (128 images; 128 rows over 50
    # images); the text stream this phase adds at batch 32
    cfg.update(train_file=[img_file], train_file_regions=[region_file],
               text_encoder=tok_dir, ckpt_frequent_step=2,
               train_dataset_size=2 * PRETRAIN_BATCH,   # 2 steps an epoch
               train_file_text=[txt_file],
               texts={"caption_key": "text", "batch_size": TRAIN_BATCH, "iter_perc": 1,
                      "num_workers": 2})
    if (cfg["images"]["batch_size"], cfg["regions"]["batch_size"],
            cfg["regions"]["max_images"]) != (PRETRAIN_BATCH, REGION_ROWS, REGION_IMAGES):
        fail(f"pretrain launcher: the shipped blocks are {cfg['images']}, {cfg['regions']}; "
             f"this phase expects {PRETRAIN_BATCH} images, {REGION_ROWS} region rows over "
             f"{REGION_IMAGES} images")
    cfg_path = os.path.join(root, "pretrain.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return {"tok_dir": tok_dir, "words": words, "cfg": cfg, "cfg_path": cfg_path,
            "seconds": time.perf_counter() - t0}


def pretrain_launcher_phase(root: str, seed: int, dev, args, smi: str, data: dict):
    """Phase 7: ``x2vlm_tpu_torch.run --task pretrain`` in process on the
    data ``write_pretrain_data`` wrote under ``root``, the image, region and
    text streams: 2 steps (phase 24 runs the same run under ``torchrun``
    and holds its ``--resume``); each stream's calls timed, their losses
    kept, the region stream's launches read per call, the parameters after
    step 2 kept; the run's final weights exported as a reference-named
    ``.th``. Returns its path, the tokenizer directory and words and the
    launch counts of the run."""
    from x2vlm_tpu_torch import run as run_mod

    t0 = time.perf_counter()
    tok_dir, words, cfg, cfg_path = (data[k] for k in ("tok_dir", "words", "cfg", "cfg_path"))
    # phase 24's rank starts now: its imports and process group overlap this run
    PHASE7["ddp"] = DdpRank(root, seed, cfg)
    PHASE7["ddp"].start()
    # the train states (~3.4 GB, three saves) go to RAM: the call's disk-write cap
    work = work_dir(root, 12 * 2**30)
    out = os.path.join(work, "out_pretrain")
    argv = ["--task", "pretrain", "--config", cfg_path, "--output_dir", out,
            "--seed", str(seed), "--device", dev.type]
    log(f"phase 7 data and config: {data['seconds']:.1f} s, written while the kernels built")

    t1 = time.perf_counter()
    reset_counts()
    profiled = args is not None and args.profile
    orig_save = run_mod.ckpt_lib.save_train_state

    def save_keeping(ckpt_dir, model, optimizer, step, data_state=None):
        path = orig_save(ckpt_dir, model, optimizer, step, data_state)
        if step == DDP_STEPS:   # phase 24's parameter hold reads the state after step 2
            PHASE7["step_params"] = {n: p.detach().cpu().clone()
                                     for n, p in model.named_parameters()}
        return path

    run_mod.ckpt_lib.save_train_state = save_keeping
    try:
        with StreamTimer(("region", LAUNCH_STEPS - 1) if profiled else None,
                         (args, smi, "chip_smoke_region_profile.txt")) as timer:
            record = run_mod.main(argv + ["--epoch", str(LAUNCH_STEPS // 2)])
            check_data_plane("phase 7", record)
    finally:
        run_mod.ckpt_lib.save_train_state = orig_save
    torch.cuda.synchronize()
    PHASE7.update(cfg=cfg, calls=timer.calls)
    counts1 = launch_counts()
    log(f"phase 7 run 1 ({LAUNCH_STEPS} steps): {part_done('7', 'run', t1):.1f} s; "
        f"{json.dumps(record)}")
    if not all(math.isfinite(v) for v in record.values() if isinstance(v, float)):
        fail(f"pretrain launcher: non-finite metrics {record}")
    if record.get("broken", -1) != 0:
        fail(f"pretrain launcher: broken samples {record.get('broken')}")
    want_losses = [f"region_loss_{k}" for k in ("itc", "itm", "mlm", "bbox", "giou")]
    if not all(isinstance(record.get(k), float) for k in want_losses):
        fail(f"pretrain launcher: region losses {[record.get(k) for k in want_losses]}")
    n = LAUNCH_STEPS
    n_fusion = 6
    region = region_step_launches(n_fusion)
    want_tiny = collections.Counter({(2 * PRETRAIN_BATCH, TEXT_LEN, TEXT_LEN): 12 * n,
                                     (4 * PRETRAIN_BATCH, TEXT_LEN, TEXT_LEN): n_fusion * n,
                                     (4 * PRETRAIN_BATCH, TEXT_LEN, 200): n_fusion * n,
                                     (TRAIN_BATCH, TEXT_LEN, TEXT_LEN): 18 * n})
    want_tiny.update({k: v * n for k, v in region.items()})
    check_launcher_counts("pretrain launcher", counts1, 24 * n, 24 * n,
                          {"tiny_fwd": dict(want_tiny), "tiny_bwd": dict(want_tiny)})
    # each image-stream call: 12 of each flash kernel at B=128
    for i, c in enumerate(timer.calls["image"]):
        if dict(c["launches"]["flash_fwd_shapes"]) != {(PRETRAIN_BATCH, N_IMG, N_IMG): 12}:
            fail(f"pretrain launcher image step {i}: flash shapes "
                 f"{dict(c['launches']['flash_fwd_shapes'])}, expected 12 at B={PRETRAIN_BATCH}")
    # the region stream alone, each of its calls: 12 of each flash kernel at
    # B=50, its tiny launches, all on the tensor-core route
    region_calls = timer.calls["region"]
    if len(region_calls) != n:
        fail(f"pretrain launcher: {len(region_calls)} region-stream calls, expected {n}")
    for i, c in enumerate(region_calls):
        check_launcher_counts(f"pretrain launcher region step {i}", c["launches"], 12, 12,
                              {"tiny_fwd": region, "tiny_bwd": region})
    log(f"phase 7 by stream (CUDA-event ms and wall ms of each call, median; peak GiB; "
        f"{smi}): {json.dumps(timer.summary())}")

    # the resume of this run is held by phase 24, through torchrun
    state_path = os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE)
    final = load_params(state_path)
    th_path = os.path.join(root, "x2vlm_phase7.th")
    torch.save({"model": {k[len("base."):]: v for k, v in final.items()}}, th_path)
    if work != root:
        shutil.rmtree(work, ignore_errors=True)
    phase_seconds("7", t0)
    return th_path, tok_dir, words, counts1


# ---- phase 24: multi-GPU training and remote storage at world 1 ----
DDP_STEPS, DDP_RESUME_STEPS = 2, 3   # 2 steps under torchrun, then --resume takes a third
DDP_HOLD_COSINE, DDP_HOLD_REL_L2 = 0.9999, 1e-3   # phase 16's rule, per family
DDP_WAIT_S, DDP_RUN_S = 900, 600   # the rank's wait for phase 7, and its run after
# A stand-in ``hdfs`` command-line tool (the surface core/io.py drives:
# -cat, -ls, -test, -put [-f] of a file, a directory or standard input,
# -get, -mkdir -p) over a local directory: hdfs://smoke/<p> is ROOT/<p>.
HDFS_STANDIN = """#!/usr/bin/env python3
import os, shutil, sys
ROOT = {root!r}
def local(p):
    assert p.startswith("hdfs://smoke/"), p
    return os.path.join(ROOT, p[len("hdfs://smoke/"):])
args = [a for a in sys.argv[1:] if a != "-f"]
op = args[1]
if op == "-cat":
    sys.stdout.buffer.write(open(local(args[2]), "rb").read())
elif op == "-ls":
    d = local(args[2])
    for f in sorted(os.listdir(d)):
        print("-rw-r--r--   1 u g 0 2024-01-01 00:00 hdfs://smoke/" +
              os.path.relpath(os.path.join(d, f), ROOT))
elif op == "-test":
    sys.exit(0 if os.path.exists(local(args[3])) else 1)
elif op == "-mkdir":
    os.makedirs(local(args[3 if args[2] == "-p" else 2]), exist_ok=True)
elif op == "-put":
    src, dst = args[2], local(args[3])
    if src == "-":
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            shutil.copyfileobj(sys.stdin.buffer, f)
    elif os.path.isdir(src):
        dst = os.path.join(dst, os.path.basename(src.rstrip("/")))
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
    else:
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy(src, dst)
elif op == "-get":
    src, dst = local(args[2]), args[3]
    if os.path.isdir(dst):
        dst = os.path.join(dst, os.path.basename(src))
    shutil.copy(src, dst)
else:
    sys.exit(2)
"""


def launcher_command() -> list:
    """``torchrun``, or ``python -m torch.distributed.run`` where this host
    has no ``torchrun`` script on its PATH."""
    exe = shutil.which("torchrun")
    return [exe] if exe else [sys.executable, "-m", "torch.distributed.run"]


def phase24_child(spec_path: str) -> int:
    """Phase 24's rank, started by ``torchrun`` (``--phase24-child SPEC``)
    while phase 7 runs: it joins the process group ``torchrun`` describes
    (NCCL, world 1) and waits for the spec's ``go`` file (phase 7 done, the
    card free), then runs ``x2vlm_tpu_torch.run.main`` for ``DDP_STEPS``
    steps and ``--resume`` to ``DDP_RESUME_STEPS`` with ``--output_hdfs``;
    each call timed and counted (``StreamTimer``), the resumed state held
    against the saved one, the state after ``DDP_STEPS`` linked aside for
    the parameter hold. Writes its readings to the spec's ``result`` (a
    torch pickle)."""
    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.core import mesh

    t_entry = time.perf_counter()
    parent = os.getppid()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    argv = spec["argv"]
    out = {"env": {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}}
    with open(spec["pid"], "w") as f:   # the script stops this process if it must
        f.write(str(os.getpid()))
    mesh.initialize("cuda")   # run.main joins this group
    torch.ones(1, device="cuda").sum().item()
    out["ready_s"] = time.perf_counter() - t_entry
    deadline = time.monotonic() + DDP_WAIT_S
    while not os.path.exists(spec["go"]):
        if time.monotonic() > deadline or os.getppid() != parent:
            raise TimeoutError("phase 24: no go file, or the torchrun agent is gone")
        time.sleep(0.05)
    t = time.perf_counter()
    reset_counts()
    with StreamTimer() as timer:
        record = run_mod.main(argv + ["--epoch", str(DDP_STEPS)])
    torch.cuda.synchronize()
    out.update(group=mesh.describe(), record=record, run_s=time.perf_counter() - t,
               calls=dict(timer.calls), counts=launch_counts())
    state_path = os.path.join(spec["output_dir"], "ckpt", ckpt_lib.TRAIN_STATE_FILE)
    os.link(state_path, spec["step_state"])   # run 2 replaces the file, not the inode
    saved = torch.load(state_path, map_location="cpu", weights_only=False, mmap=True)
    seen = {}
    orig = run_mod.maybe_resume

    def resumed(a, model, optimizer):
        step, data_state = orig(a, model, optimizer)
        params = dict(model.named_parameters())
        seen.update(
            step=step, data_state=data_state,
            params=all(torch.equal(params[k].detach().cpu(), v)
                       for k, v in saved["params"].items()),
            mu=all(torch.equal(m.cpu(), saved["mu"][k])
                   for k, m in zip(optimizer.names, optimizer.mu)),
            nu=all(torch.equal(v.cpu(), saved["nu"][k])
                   for k, v in zip(optimizer.names, optimizer.nu)),
            count=optimizer.count == saved["count"])
        return step, data_state

    t = time.perf_counter()
    run_mod.maybe_resume = resumed
    try:
        with StreamTimer() as timer2:
            record2 = run_mod.main(argv + ["--resume", "--epoch", str(DDP_RESUME_STEPS),
                                           "--output_hdfs", spec["output_hdfs"]])
    finally:
        run_mod.maybe_resume = orig
    torch.cuda.synchronize()
    out.update(resume_s=time.perf_counter() - t, seen=seen, saved_step=int(saved["step"]),
               saved_data_state=saved["data_state"], record2=record2,
               calls2=dict(timer2.calls), counts2=launch_counts())
    torch.save(out, spec["result"])
    mesh.shutdown()
    return 0


def same_tree(a: str, b: str) -> list:
    """The files of two directories that differ in name or bytes."""
    def files(root):
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs}
    def same(x, y, chunk=64 * 2**20):
        if os.path.getsize(x) != os.path.getsize(y):
            return False
        with open(x, "rb") as fx, open(y, "rb") as fy:
            while True:
                bx, by = fx.read(chunk), fy.read(chunk)
                if bx != by:
                    return False
                if not bx:
                    return True

    fa, fb = files(a), files(b)
    diff = sorted(fa ^ fb)
    diff += [rel for rel in sorted(fa & fb)
             if not same(os.path.join(a, rel), os.path.join(b, rel))]
    return diff


def param_family_rule(got: dict, want: dict, fusion_layer: int) -> dict:
    """Phase 16's reading per family (``grad_families``' prefixes) of the
    parameters ``got`` against ``want``: cosine and relative L2."""
    p = "base.text_encoder.bert.encoder.layer."
    fams = {"vision": ("base.vision_encoder.",), "text layer": (f"{p}0.",),
            "fusion layer": (f"{p}{fusion_layer}.",),
            "heads": ("base.itm_head.", "base.vision_proj.", "base.text_proj.",
                      "base.text_encoder.cls.")}
    out = {}
    dev = torch.device("cuda", 0)
    for f, pre in fams.items():
        names = [n for n in want if n.startswith(pre)]
        pairs = [(got[n].to(dev).double(), want[n].to(dev).double()) for n in names]
        dot = sum((a * b).sum() for a, b in pairs)
        na = sum((a ** 2).sum() for a, _ in pairs).sqrt()
        nb = sum((b ** 2).sum() for _, b in pairs).sqrt()
        diff = sum(((a - b) ** 2).sum() for a, b in pairs).sqrt()
        del pairs
        out[f] = {"cosine": (dot / (na * nb)).item(), "rel_l2": (diff / nb).item(),
                  "params": len(names)}
    return out


class DdpRank:
    """Phase 24's ``torchrun`` (its stand-in ``hdfs`` tool, its config on
    the tool's side, its RAM work directory), started by :meth:`start`
    while phase 7 runs: the rank imports, reaches the card and joins its
    process group meanwhile, and waits for :meth:`release`. :meth:`stop`
    kills it (and the torchrun agent) wherever it is."""

    def __init__(self, root: str, seed: int, cfg: dict):
        t0 = time.perf_counter()
        base = work_dir(root, 12 * 2**30)
        self.work = base if base != root else tempfile.mkdtemp(prefix="phase24_", dir=root)
        self.hdfs_root = os.path.join(self.work, "hdfs_root")
        os.makedirs(self.hdfs_root)
        # the tool beside the kernels' libraries: /dev/shm may not execute files
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.bin_dir = tempfile.mkdtemp(prefix="phase24_bin_", dir=_build.BUILD_DIR)
        tool = os.path.join(self.bin_dir, "hdfs")
        with open(tool, "w") as f:
            f.write(HDFS_STANDIN.format(root=self.hdfs_root))
        os.chmod(tool, 0o755)
        # one step an epoch, and a save after the last step of each run only
        self.cfg = dict(cfg, train_dataset_size=PRETRAIN_BATCH,
                        ckpt_frequent=DDP_RESUME_STEPS + 1)
        with open(os.path.join(self.hdfs_root, "pretrain.json"), "w") as f:
            json.dump(self.cfg, f)
        self.out = os.path.join(self.work, "out_ddp")
        w = self.work
        self.spec = {"argv": ["--task", "pretrain", "--config", "hdfs://smoke/pretrain.json",
                              "--output_dir", self.out, "--seed", str(seed), "--device", "cuda"],
                     "output_dir": self.out, "output_hdfs": "hdfs://smoke/mirror",
                     "step_state": os.path.join(w, "step2_state.pt"),
                     "result": os.path.join(w, "result.pt"), "go": os.path.join(w, "go"),
                     "pid": os.path.join(w, "rank.pid")}
        self.spec_path = os.path.join(w, "spec.json")
        with open(self.spec_path, "w") as f:
            json.dump(self.spec, f)
        self.cmd = launcher_command() + ["--standalone", "--nproc_per_node", "1",
                                         os.path.abspath(__file__), "--phase24-child",
                                         self.spec_path]
        self.proc = None
        self.setup_s = time.perf_counter() - t0

    def start(self) -> None:
        env = dict(os.environ, PATH=f"{self.bin_dir}:{os.environ.get('PATH', '')}")
        self.log_path = os.path.join(self.work, "rank.log")
        with open(self.log_path, "w") as logf:
            self.proc = subprocess.Popen(self.cmd, env=env, stdout=logf,
                                         stderr=subprocess.STDOUT, start_new_session=True)
        self.t_start = time.perf_counter()

    def release(self) -> int:
        """Let the rank run; returns its exit code (it has ``DDP_RUN_S``)."""
        self.t_go = time.perf_counter()
        open(self.spec["go"], "w").close()
        try:
            return self.proc.wait(timeout=DDP_RUN_S)
        except subprocess.TimeoutExpired:
            self.stop()
            return -1

    def log_tail(self, n: int = 6000) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()[-n:]

    def stop(self) -> None:
        """Kill the agent's process group and the rank (torchrun starts it in
        a session of its own)."""
        if self.proc is None:
            return
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=60)
        try:
            with open(self.spec["pid"]) as f:
                os.kill(int(f.read()), signal.SIGKILL)
        except (OSError, ValueError):
            pass   # no pid written, or the rank has exited

    def cleanup(self) -> None:
        self.stop()
        shutil.rmtree(self.bin_dir, ignore_errors=True)
        shutil.rmtree(self.work, ignore_errors=True)


def ddp_launcher_phase(rank: "DdpRank", smi: str = ""):
    """Phase 24: phase 7's pretraining run (its config, data and seed) as a
    user starts it on N cards, ``torchrun --nproc_per_node 1``, at world 1
    (NCCL): its ``--config`` read from ``hdfs://`` and its ``output_dir``
    mirrored to ``--output_hdfs`` through a stand-in ``hdfs`` tool (the rank
    started by phase 7, ``DdpRank``). Held: the process group; each step's
    launches equal to phase 7's step's, stream by stream; steps 1 and 2's
    losses equal to phase 7's bit for bit (the first update's lr is 0, so
    step 2 reads step 1's weights); the parameters after step 2 against
    phase 7's by phase 16's rule; the resumed state and cursors equal to
    the saved ones bit for bit; the mirror equal to ``output_dir`` byte for
    byte. Returns the launches of the two runs."""
    t0 = time.perf_counter()
    code = rank.release()
    log(f"phase 24 torchrun (exit {code}; set up in {rank.setup_s:.1f} s and started "
        f"{t0 - rank.t_start:.1f} s before phase 7 ended): {part_done('24', 'run', t0):.1f} "
        f"s after phase 7; {' '.join(rank.cmd)}")
    spec, out, hdfs_root, cfg = rank.spec, rank.out, rank.hdfs_root, rank.cfg
    if code != 0 or not os.path.isfile(spec["result"]):
        fail(f"phase 24: torchrun exited {code}:\n{rank.log_tail()}")
        return {}
    t2 = time.perf_counter()
    r = torch.load(spec["result"], weights_only=False)
    group = r["group"]
    log(f"phase 24 process group: {json.dumps(group)}; torchrun environment "
        f"{json.dumps(r['env'])}; the rank ready (imports, card, group) in "
        f"{r['ready_s']:.1f} s, run {r['run_s']:.1f} s, resumed run {r['resume_s']:.1f} s")
    if (group["backend"], group["world_size"], group["rank"], group["device"]) != \
            ("nccl", 1, 0, "cuda:0") or r["env"]["WORLD_SIZE"] != "1":
        fail(f"phase 24: process group {group}, environment {r['env']}")
    # each step's launches and losses against phase 7's, stream by stream
    p7 = PHASE7["calls"]
    rows = {}
    for stream in ("image", "region", "text", "apply"):
        calls = r["calls"].get(stream, []) + r["calls2"].get(stream, [])
        if len(calls) != DDP_RESUME_STEPS:
            fail(f"phase 24 {stream}: {len(calls)} calls, expected {DDP_RESUME_STEPS}")
            continue
        for i, c in enumerate(calls):
            want = p7[stream][min(i, len(p7[stream]) - 1)]   # every step launches alike
            if c["launches"] != want["launches"]:
                fail(f"phase 24 {stream} step {i + 1}: launches {show_counts(c['launches'])} "
                     f"differ from phase 7's {show_counts(want['launches'])}")
            if i < DDP_STEPS and c["losses"] != want["losses"]:
                fail(f"phase 24 {stream} step {i + 1}: losses {c['losses']} differ from "
                     f"phase 7's {want['losses']}")
        rows[stream] = {"ms": [round(c["ms"], 3) for c in calls],
                        "phase7_ms": [round(c["ms"], 3) for c in p7[stream]],
                        "peak_gib": [round(c["peak_gib"], 2) for c in calls],
                        "phase7_peak_gib": [round(c["peak_gib"], 2) for c in p7[stream]]}
    log(f"phase 24 steps (CUDA-event ms and peak GiB of each call beside phase 7's, "
        f"{smi}): {json.dumps(rows)}")
    log(f"phase 24 step 1 losses, equal to phase 7's bit for bit: "
        f"{json.dumps({k: p7[k][0]['losses'] for k in ('image', 'region', 'text')})}")
    # the parameters after step 2
    got = load_params(spec["step_state"])
    fams = param_family_rule(got, PHASE7["step_params"],
                             xvlm_config_from_yaml(cfg).text.fusion_layer)
    for f, x in fams.items():
        if not (x["cosine"] >= DDP_HOLD_COSINE and x["rel_l2"] <= DDP_HOLD_REL_L2):
            fail(f"phase 24 parameters after step {DDP_STEPS}, {f}: {x} (limits "
                 f"{DDP_HOLD_COSINE}, {DDP_HOLD_REL_L2})")
    exact = sum(torch.equal(got[n], PHASE7["step_params"][n]) for n in got)
    log(f"phase 24 parameters after step {DDP_STEPS} against phase 7's by family: "
        f"{json.dumps(fams)}; {exact} of {len(got)} tensors equal bit for bit")
    del got
    # the resume
    seen = r["seen"]
    log(f"phase 24 --resume: resumed at step {seen.get('step')}, cursors "
        f"{seen.get('data_state')}; equal to the saved state: params {seen.get('params')}, "
        f"mu {seen.get('mu')}, nu {seen.get('nu')}, count {seen.get('count')}; "
        f"{json.dumps(r['record2'])}")
    if not (seen.get("step") == r["saved_step"] == DDP_STEPS and seen.get("params")
            and seen.get("mu") and seen.get("nu") and seen.get("count")
            and seen.get("data_state") == r["saved_data_state"]
            and set(r["saved_data_state"]) == {"image", "region", "text"}):
        fail(f"phase 24 --resume: {seen} against the saved step {r['saved_step']}")
    if r["record2"].get("pretrain_steps") != [DDP_STEPS, DDP_RESUME_STEPS]:
        fail(f"phase 24 --resume: {r['record2']}")
    # the remote config and the mirror
    diff = same_tree(out, os.path.join(hdfs_root, "mirror"))
    log(f"phase 24 --output_hdfs mirror: {len(os.listdir(out))} entries, "
        f"{'equal byte for byte' if not diff else f'differing: {diff}'}")
    if diff or not os.path.isfile(os.path.join(out, "pretrain.json")):
        fail(f"phase 24: the mirror differs from output_dir in {diff}, or the remote config "
             f"was not fetched")
    part_done("24", "hold", t2)
    phase_seconds("24", t0)
    return {k: r["counts2"][k] for k in LEDGER_PARTS}   # both runs' (counted from 0)


# Phase 8's hold on the fine-tuned model at 384 px, through its own calls:
# (1) every 40 x 584 call the model makes into the tiny kernel in bf16 is
# held, on the operands the model gave it, to the plain version: a call's
# ``ratio`` is its error over the bf16 rule's bound, at most
# ``FUSION_CALL_RATIO`` (half the rule: the kernel rounds as the plain bf16
# version does, 0.22-0.26, while a key mask ignored reads 1.07-1.26);
# (2) the fusion stack's CLS output of 8 pairs (the ITM head's input) on the
# card against the port's CPU fp32 path, its error over the pairs' spread
# (the distance of the CPU features from their mean over the pairs, so what
# is common to every pair does not hide a fault): in fp32 the card runs the
# CUDA-core kernels and the error is rounding only; in bf16 the limit is a
# gross guard, ~2.7x the readings of the sources as they are. The limits
# sit between the readings of the sources and of copies with a planted
# fault (tools/fusion384_faults.py; PERF.md).
FUSION_LIMITS = {"bf16": 0.25, "fp32": 1e-3}
FUSION_CALL_RATIO = 0.5


@contextlib.contextmanager
def held_tiny_calls(n_keys: int, ratios: list, only=None):
    """Within the block, each bf16 call the model makes on the card into the
    tiny kernel (``ops.layers.tiny_block_attention``) with ``n_keys`` keys,
    no dropout and, given ``only``, ``only(key_mask)`` true, is held on the
    operands the model gave it to the plain version: its error over the
    bf16 rule's bound is appended to ``ratios``."""
    from x2vlm_tpu_torch.ops import layers as layers_mod

    block_attention = layers_mod.tiny_block_attention

    def held(qw, kw, vw, **kwargs):
        out = block_attention(qw, kw, vw, **kwargs)
        km = kwargs.get("key_mask")
        dropout = kwargs.get("training") and kwargs.get("dropout_rate", 0.0) > 0.0
        if out.is_cuda and out.dtype == torch.bfloat16 and kw.shape[1] == n_keys and \
                not dropout and (only is None or only(km)):
            with torch.no_grad():
                ref = functools.partial(tiny_attention_reference,
                                        num_heads=kwargs["num_heads"], key_mask=km,
                                        scale=kwargs["scale"])
                truth = ref(qw.float(), kw.float(), vw.float())[0]
                bound = max(4.0 * max_err(ref(qw, kw, vw)[0], truth),
                            1e-3 * max(truth.abs().max().item(), 1e-6))
                ratios.append(max_err(out.detach(), truth) / bound)
        return out

    layers_mod.tiny_block_attention = held
    try:
        yield
    finally:
        layers_mod.tiny_block_attention = block_attention


def fusion_384_readings(state, mcfg, images, ids, atts, dev) -> dict:
    """``itm_score`` of every image against every text with the weights
    ``state`` on the card in bf16 and fp32 and on the CPU in fp32; the
    fusion CLS features are read at the ITM head's input and the card's
    bf16 40 x 584 tiny calls at ``ops.layers.tiny_block_attention``.
    Returns, per card dtype, the largest error of a pair's features over
    the median spread (``spread_err``) and over its own norm
    (``rel_err``), the ITM scores' largest error and the card run's tiny
    and plain-attention launches; for bf16 also each held call's ratio;
    and the CPU scores' range."""
    n_img, n_txt = images.shape[0], ids.shape[0]
    feats, scores, counts, ratios = {}, {}, {}, []
    for tag, dtype, device in (("bf16", torch.bfloat16, dev), ("fp32", torch.float32, dev),
                               ("cpu", torch.float32, torch.device("cpu"))):
        model = XVLMForRetrieval(mcfg, dtype=dtype, device=device, seed=None)
        model.load_state_dict(state)
        hook = model.itm_head.register_forward_hook(
            lambda mod, inp, out, tag=tag: feats.__setitem__(tag, inp[0].float().cpu()))
        reset_counts()
        dot_product_attention.calls = 0
        try:
            with held_tiny_calls(N_KEYS_384, ratios), torch.inference_mode():
                img, _ = model.encode_images(images.to(device))
                txt, _ = model.encode_texts(ids.to(device), atts.to(device))
                scores[tag] = model.itm_score(
                    img.repeat_interleave(n_txt, 0), txt.repeat(n_img, 1, 1),
                    atts.to(device).repeat(n_img, 1)).float().cpu()
        finally:
            hook.remove()
        if device.type == "cuda":
            torch.cuda.synchronize()
            c = launch_counts()
            counts[tag] = {"tiny_fwd": {str(k): v for k, v in c["tiny_fwd"].items()},
                           "tiny_routes": c["tiny_routes"]["tiny_attention_fwd"],
                           "tiny_walks": c["tiny_walks"]["tiny_attention_fwd"],
                           "plain_attention": c["plain_attention"]}
        del model
    torch.cuda.empty_cache()
    ref = feats["cpu"]
    spread = (ref - ref.mean(0)).norm(dim=1).median().item()
    out = {"pairs": n_img * n_txt, "spread": spread,
           "cpu_score_range": [scores["cpu"].min().item(), scores["cpu"].max().item()]}
    for tag in ("bf16", "fp32"):
        err = (feats[tag] - ref).norm(dim=1)
        out[tag] = {"spread_err": err.max().item() / spread,
                    "rel_err": (err / ref.norm(dim=1)).max().item(),
                    "itm_err": max_err(scores[tag], scores["cpu"]), **counts[tag]}
    out["bf16"]["call_ratios"] = ratios
    return out


def fusion_384_faults(r: dict) -> list:
    """What phase 8's hold finds wrong in ``fusion_384_readings``: a held
    call past ``FUSION_CALL_RATIO``, an error over its limit, the ITM
    scores past phase 3's rule, or a 40 x 584 launch off its route and
    walk."""
    faults = []
    ratios = r["bf16"]["call_ratios"]
    if len(ratios) != 6 or not all(x <= FUSION_CALL_RATIO for x in ratios):
        faults.append(f"bf16: the 40 x {N_KEYS_384} calls' errors over the rule's bound "
                      f"{[round(x, 3) for x in ratios]}, expected 6 at most "
                      f"{FUSION_CALL_RATIO}")
    scale = max(abs(x) for x in r["cpu_score_range"])
    shape = str((r["pairs"], TEXT_LEN, N_KEYS_384))
    for tag, route in (("bf16", TENSOR_CORE), ("fp32", CUDA_CORE)):
        x = r[tag]
        if not x["spread_err"] <= FUSION_LIMITS[tag]:
            faults.append(f"{tag}: feature error {x['spread_err']:.4g} of the pairs' spread "
                          f"> {FUSION_LIMITS[tag]}")
        if not x["itm_err"] <= 0.05 + 0.05 * scale:
            faults.append(f"{tag}: ITM score error {x['itm_err']:.4f} > 0.05 + 5% of {scale:.4f}")
        if x["plain_attention"] or x["tiny_fwd"].get(shape, 0) != 6 or \
                x["tiny_routes"] != {route: sum(x["tiny_fwd"].values())} or \
                x["tiny_walks"].get(TILED, 0) != 6:
            faults.append(f"{tag}: launches {x}, expected 6 at {shape} on {route}, key-tiled, "
                          f"and no plain attention")
    return faults


def retrieval_launcher_phase(args, root: str, th_path: str, tok_dir: str, words, dev,
                             smi: str = ""):
    """Phase 8: ``x2vlm_tpu_torch.run --task retrieval`` at 384 px from
    phase 7's ``.th`` (rel-pos tables interpolated 14 -> 24): 4 fine-tune
    steps at batch 32, then the two-stage eval with k_test 128; the card's
    ITM scores against the port's CPU fp32 path. With ``--profile`` the last
    fine-tune step and the eval run under torch.profiler (their wall times
    then include its cost). Returns the launch counts, split into those of
    the steps and of the eval (``split_counts``)."""
    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.tasks import retrieval as retrieval_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 8)
    img_root = os.path.join(root, "flickr")
    os.makedirs(img_root)
    test_ann = []
    for i in range(N_LAUNCH_IMAGES):
        with open(os.path.join(img_root, f"{i}.png"), "wb") as f:
            f.write(random_png(rng, 320))
        test_ann.append({"image": f"{i}.png", "image_id": i,
                         "caption": [caption(rng, words) for _ in range(5)]})
    train_ann = [{"image": a["image"], "image_id": a["image_id"], "caption": c}
                 for a in test_ann[:N_FT_STEPS * TRAIN_BATCH // 2] for c in a["caption"][:2]]
    paths = {}
    for name, ann in (("train", train_ann), ("test", test_ann)):
        paths[name] = os.path.join(root, f"flickr_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(ann, f)
    cfg = dict(shipped_config(RETRIEVAL_CONFIG), train_file=[paths["train"]],
               test_file=[paths["test"]], image_root=img_root, text_encoder=tok_dir)
    cfg_path = os.path.join(root, "retrieval.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(root, "out_retrieval")
    log(f"phase 8 data and config: {part_done('8', 'data', t0):.1f} s")

    imported = {}
    orig_load = ckpt_lib.load_reference_checkpoint
    orig_step = run_mod.make_train_step
    step_ms, step_counts = [], []

    def load(model, path):
        imported["missing"], imported["unexpected"] = orig_load(model, path)
        return imported["missing"], imported["unexpected"]

    def make_step(model, optimizer, **kw):
        step = orig_step(model, optimizer, **kw)

        def timed(*a):
            last = args.profile and len(step_ms) == N_FT_STEPS - 1   # profiled
            before = launch_counts()
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as prof:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                start.record()
                m = step(*a)
                end.record()
                end.synchronize()
            step_ms.append((start.elapsed_time(end), (time.perf_counter() - t) * 1e3))
            step_counts.append(counts_delta(launch_counts(), before))
            if last:
                write_profile(args, smi, prof, "chip_smoke_finetune384_profile.txt", 40)
            return m

        return timed

    orig_eval = retrieval_mod.evaluate_retrieval

    def evaluate(*a, **kw):
        if not args.profile:
            return orig_eval(*a, **kw)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            metrics = orig_eval(*a, **kw)
            torch.cuda.synchronize()
        write_profile(args, smi, prof, "chip_smoke_eval384_profile.txt", 40)
        return metrics

    t1 = time.perf_counter()
    reset_counts()
    ckpt_lib.load_reference_checkpoint, run_mod.make_train_step = load, make_step
    retrieval_mod.evaluate_retrieval = evaluate
    try:
        record = run_mod.main(["--task", "retrieval", "--config", cfg_path, "--output_dir", out,
                               "--checkpoint", th_path, "--epoch", "1", "--seed",
                               str(args.seed), "--device", dev.type])
    finally:
        ckpt_lib.load_reference_checkpoint, run_mod.make_train_step = orig_load, orig_step
        retrieval_mod.evaluate_retrieval = orig_eval
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"phase 8 run ({len(step_ms)} fine-tune steps + eval): "
        f"{part_done('8', 'run', t1):.1f} s; "
        f"{json.dumps(record)}")
    log(f"phase 8 fine-tune step ms at 384 px, B={TRAIN_BATCH} (CUDA events, wall): "
        f"{json.dumps([[round(a, 3), round(b, 3)] for a, b in step_ms])}"
        f"{' (the last one profiled)' if args.profile else ''}; eval seconds "
        f"{record.get('eval_eval_seconds')} ({N_LAUNCH_IMAGES} images, "
        f"{5 * N_LAUNCH_IMAGES} texts, k_test {cfg['k_test']})")
    # the import: the 224 px .th at 384 px, every parameter loaded; left over
    # are the MLM and bbox heads, which a retrieval model does not carry
    unexpected = imported.get("unexpected", [])
    log(f"phase 8 import: missing {imported.get('missing')}, unexpected {len(unexpected)} "
        f"({sorted({'.'.join(k.split('.')[:2]) for k in unexpected})})")
    if imported.get("missing") != [] or not all(
            k.startswith(("text_encoder.cls.predictions.", "bbox_head."))
            for k in imported.get("unexpected", [])):
        fail(f"retrieval launcher import of {th_path}: missing {imported.get('missing')}, "
             f"unexpected {imported.get('unexpected')}")
    keys = ("txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "img_r1", "img_r5", "img_r10",
            "img_r_mean", "r1_mean", "r_mean")
    vals = [record.get(f"eval_{k}") for k in keys]
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals):
        fail(f"retrieval launcher: eval metrics {dict(zip(keys, vals))}")
    if len(step_ms) != N_FT_STEPS or not math.isfinite(record.get("loss_total", math.nan)):
        fail(f"retrieval launcher: {len(step_ms)} steps, loss {record.get('loss_total')}")
    n_fusion = 6
    n_i2t, n_t2i = N_LAUNCH_IMAGES // 8, 5 * N_LAUNCH_IMAGES // 8
    n_img_384 = N_IMG_384 + (-N_IMG_384 % 8)
    check_launcher_counts(
        "retrieval launcher", counts, 12 * (N_FT_STEPS + 1), 12 * N_FT_STEPS,
        {"tiny_fwd": {(TRAIN_BATCH, TEXT_LEN, TEXT_LEN): 12 * N_FT_STEPS,
                      (3 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN): n_fusion * N_FT_STEPS,
                      (3 * TRAIN_BATCH, TEXT_LEN, n_img_384): n_fusion * N_FT_STEPS,
                      (256, TEXT_LEN, TEXT_LEN): 12 * 2,
                      (RERANK_BATCH, TEXT_LEN, TEXT_LEN): n_fusion * n_i2t,
                      (RERANK_BATCH, TEXT_LEN, n_img_384): n_fusion * n_i2t,
                      (RERANK_BATCH // 2, TEXT_LEN, TEXT_LEN): n_fusion * n_t2i,
                      (RERANK_BATCH // 2, TEXT_LEN, n_img_384): n_fusion * n_t2i},
         "tiny_bwd": {(TRAIN_BATCH, TEXT_LEN, TEXT_LEN): 12 * N_FT_STEPS,
                      (3 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN): n_fusion * N_FT_STEPS,
                      (3 * TRAIN_BATCH, TEXT_LEN, n_img_384): n_fusion * N_FT_STEPS}})

    # the fine-tuned weights through the model's own calls at 384 px: the
    # card in bf16 and in fp32 against the port's CPU fp32 path, 8 pairs
    state = load_params(os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE))
    _, test_ds = create_dataset("retrieval", cfg, evaluate=True)
    images = torch.from_numpy(test_ds.image_batch([0, 1]))
    ids, atts = (torch.from_numpy(a) for a in test_ds.text_batch([0, 1, 5, 6]))
    t_hold = time.perf_counter()
    readings = fusion_384_readings(state, xvlm_config_from_yaml(cfg), images, ids, atts, dev)
    part_done("8", "hold", t_hold)
    log(f"phase 8 fusion at 384 px, 8 pairs, card vs CPU fp32: {json.dumps(readings)}")
    for msg in fusion_384_faults(readings):
        fail(f"retrieval launcher, fusion at 384 px: {msg}")
    phase_seconds("8", t0)
    return split_counts(counts, step_counts)


# ---- phase 9: the launcher's grounding and NLVR2 fine-tunes at 384 px ----

GROUNDING_CONFIG = "configs/finetune/refcoco_grounding_base.yaml"
NLVR_CONFIG = "configs/finetune/nlvr_base.yaml"
N_FT_EVAL = 2 * FT_EVAL_BATCH        # phase 9's eval lines: 2 eval calls a task


@contextlib.contextmanager
def held_tiny_bwd_calls(n_keys: int, ratios: list):
    """Within the block, each bf16 backward on the card of the model's tiny
    attention (``ops.tiny_attention._TinyAttention``) with ``n_keys`` keys
    is held on the operands it saved, the forward's probabilities and
    output among them, to the plain backward of the walk the kernel takes:
    on the key-tiled walk it takes its row sums from that output, as the
    key-tiled kernel does (rowsum(g * out)); on the resident walk from dP,
    dm and P, as the resident kernels do. Its largest error over the bf16
    rule's bound (dq, dk, dv) is appended to ``ratios``. The saved tensors are read once (a rematerialised block's
    may be unpacked only once) and handed to the backward."""
    from x2vlm_tpu_torch.ops.tiny_attention import _TinyAttention

    backward = _TinyAttention.backward

    class Saved:
        def __init__(self, ctx, saved):
            self.ctx, self.saved_tensors = ctx, saved

        def __getattr__(self, name):
            return getattr(self.ctx, name)

    def held(ctx, g):
        saved = ctx.saved_tensors
        grads = backward(Saved(ctx, saved), g)
        q, k, v, probs, dmask, out = saved
        if q.is_cuda and q.dtype == torch.bfloat16 and k.shape[1] == n_keys:
            with torch.no_grad():
                args = (ctx.num_heads, ctx.scale)
                tiled = tiny_walk(q.shape[1], k.shape[1], q.shape[2] // ctx.num_heads) == TILED
                plain = tiny_attention_bwd_reference(q, k, v, probs, dmask, g, *args,
                                                     out=out if tiled else None)
                truth = tiny_attention_bwd_reference(
                    *as_f32(q, k, v), probs, None if dmask is None else dmask.float(),
                    g.float(), *args)
                ratios.append(max(
                    max_err(a, t) / max(4.0 * max_err(p, t),
                                        1e-3 * max(t.abs().max().item(), 1e-6))
                    for a, p, t in zip(grads[:3], plain, truth)))
        return grads

    _TinyAttention.backward = staticmethod(held)
    try:
        yield
    finally:
        _TinyAttention.backward = staticmethod(backward)


def write_grounding_corpus(root: str, rng: np.random.Generator, words, n_images: int,
                           n_train: int = GROUNDING_BATCH * N_FT_STEPS,
                           n_test: int = N_FT_EVAL, name: str = "refcoco"):
    """RefCOCO-style lines over the ``n_images`` PNGs of phase 8 (320 px):
    {image, bbox: pixel xywh, text, ref_id}, a fifth of the texts naming
    left or right (the careful hflip); ``n_train`` train lines, ``n_test``
    test lines and a ``refs_file`` giving each test line its split (val /
    testA / testB), box and image size. Returns the (train, test, refs)
    paths."""
    side = 320

    def line(i):
        w, h = (int(x) for x in rng.integers(24, 200, 2))
        x, y = float(rng.integers(0, side - w)) + 0.5, float(rng.integers(0, side - h))
        text = caption(rng, words, 2, 12)
        if rng.random() < 0.2:
            text += " on the left" if rng.random() < 0.5 else " to the right"
        return {"image": f"{i % n_images}.png", "bbox": [x, y, w, h], "text": text,
                "ref_id": i}

    train = [line(i) for i in range(n_train)]
    test = [line(1000 + i) for i in range(n_test)]
    refs = {str(a["ref_id"]): {"split": ("val", "testA", "testB")[j % 3], "bbox": a["bbox"],
                               "width": side, "height": side} for j, a in enumerate(test)}
    paths = [os.path.join(root, f"{name}_{n}.json") for n in ("train", "test", "refs")]
    for path, data in zip(paths, (train, test, refs)):
        with open(path, "w") as f:
            json.dump(data, f)
    return paths


def write_nlvr_corpus(root: str, rng: np.random.Generator, words, n_images: int):
    """NLVR2 lines {images: [a, b], sentence, label: "True" | "False"} over
    the PNGs of phase 8: ``NLVR_BATCH`` x ``N_FT_STEPS`` train lines and
    ``N_FT_EVAL`` test lines. Returns the (train, test) paths."""
    def line():
        a, b = (int(x) for x in rng.choice(n_images, 2, replace=False))
        return {"images": [f"{a}.png", f"{b}.png"], "sentence": caption(rng, words, 4, 20),
                "label": "True" if rng.random() < 0.5 else "False"}

    paths = []
    for name, n in (("train", NLVR_BATCH * N_FT_STEPS), ("test", N_FT_EVAL)):
        paths.append(os.path.join(root, f"nlvr_{name}.json"))
        with open(paths[-1], "w") as f:
            json.dump([line() for _ in range(n)], f)
    return paths


def finetune_step_launches(task: str, B: int, train: bool) -> dict:
    """The attention launches of one grounding / NLVR2 train step at batch
    ``B`` (``train``) or of one eval call: 12 flash (the vision pass over B
    or 2B images, S=577), tiny at 40 x 40 (the 12 text layers and each
    fusion pass's 6 self-attentions) and 40 x 584 (each fusion pass's 6
    cross-attentions); the backward the same."""
    n_fusion_passes = 2 if task == "nlvr" else 1
    tiny = {(B, TEXT_LEN, TEXT_LEN): 12 + 6 * n_fusion_passes,
            (B, TEXT_LEN, N_KEYS_384): 6 * n_fusion_passes}
    return {"flash_fwd": 12, "flash_bwd": 12 if train else 0, "tiny_fwd": tiny,
            "tiny_bwd": tiny if train else {}}


def call_launches(c: dict) -> dict:
    """The parts of ``counts_delta`` that ``finetune_step_launches`` states."""
    return {"flash_fwd": c["flash_fwd"], "flash_bwd": c["flash_bwd"].get("dq", 0),
            "tiny_fwd": dict(c["tiny_fwd"]), "tiny_bwd": dict(c["tiny_bwd"])}


def timed_call(args, smi, fn, records, fname, profiled):
    """``fn`` wrapped: each call timed (CUDA events and wall), its peak
    device memory and its launches (``counts_delta``; ``call_launches``
    with the plain attention's calls) appended to ``records``; the call
    with ``profiled(len(records))`` true runs under torch.profiler, its
    table written to ``args.profile/fname``."""
    def call(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if profiled(len(records)) else contextlib.nullcontext()) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            result = fn(*a, **kw)
            end.record()
            end.synchronize()
        delta = counts_delta(launch_counts(), before)
        records.append({"ms": start.elapsed_time(end),
                        "wall_ms": (time.perf_counter() - t) * 1e3,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "launches": call_launches(delta),
                        "plain": delta["plain_attention"], "delta": delta})
        if prof is not None:
            write_profile(args, smi, prof, fname, 40)
        return result

    return call


def finetune_cosine_params(cfg, head: str):
    """Gradients held to the CPU path: the vision tower (K2/K3, K4), a
    fusion layer's self and cross attention (K6, 40 x 40 and 40 x 584) and
    the task's head."""
    f = f"text_encoder.bert.encoder.layer.{cfg.text.fusion_layer}"
    return ("vision_encoder.blocks.0.attn.qkv.weight",
            "vision_encoder.blocks.0.attn.relative_position_bias_table",
            f"{f}.attention.self.query.weight", f"{f}.crossattention.self.key.weight",
            f"{head}.0.weight", f"{head}.3.weight")


def finetune_hold(task: str, state, mcfg, samples, dev) -> tuple:
    """The fine-tuned weights ``state`` (or the train state saved at that
    path) on 2 rows, dropout off: the card in
    bf16 against the port's CPU fp32 path (the task's outputs: grounding's
    boxes, NLVR2's logits; its losses; gradient cosines of
    ``finetune_cosine_params``), each bf16 40 x 584 call of the card's pass
    into the tiny forward and backward held on the model's operands to the
    plain version (``FUSION_CALL_RATIO``). Grounding's
    box targets are ``off_kink_targets`` of the CPU path's boxes. Returns
    the readings and the faults found."""
    state = params_of(state)
    from x2vlm_tpu_torch.models import XVLMForGrounding, XVLMForNLVR

    cls, head = ((XVLMForGrounding, "bbox_head") if task == "grounding"
                 else (XVLMForNLVR, "cls_head"))
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]
             if k != "ref_id"}
    if "labels" in batch:
        batch["labels"] = batch["labels"].long()
    names = finetune_cosine_params(mcfg, head)
    fwd_ratios, bwd_ratios, outs, losses, grads = [], [], {}, {}, {}
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        model = cls(mcfg, dtype=dtype, device=device, seed=None)
        model.load_state_dict(state)
        if task == "grounding" and tag == "cpu":
            batch["target_bbox"] = off_kink_targets(cpu_boxes(
                model, model.bbox_head,
                lambda: model.predict(batch["image"], batch["text_ids"], batch["text_atts"])))
        b = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            outs[tag] = (model.predict(b["image"], b["text_ids"], b["text_atts"])
                         if task == "grounding" else model.predict(b)).float().cpu()
        with held_tiny_calls(N_KEYS_384, fwd_ratios), held_tiny_bwd_calls(N_KEYS_384,
                                                                          bwd_ratios):
            out = model(b)
            sum(out.values()).backward()
        losses[tag] = {k: v.item() for k, v in out.items()}
        params = dict(model.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1) for k in names}
        del model
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in names}
    out_err = max_err(outs["card"], outs["cpu"])
    r = {"out_err": out_err, "out_scale": outs["cpu"].abs().max().item(), "losses": losses,
         "cosine": cos, "fwd_ratios": fwd_ratios, "bwd_ratios": bwd_ratios}
    faults = []
    n_calls = 6 * (2 if task == "nlvr" else 1)
    for kind, ratios in (("forward", fwd_ratios), ("backward", bwd_ratios)):
        if len(ratios) != n_calls or not all(x <= FUSION_CALL_RATIO for x in ratios):
            faults.append(f"the 40 x {N_KEYS_384} {kind} calls' errors over the bf16 rule's "
                          f"bound {[round(x, 3) for x in ratios]}, expected {n_calls} at most "
                          f"{FUSION_CALL_RATIO}")
    # boxes are fractions of the image; logits are held as phase 3 holds ITM scores
    limit = 0.02 if task == "grounding" else 0.05 + 0.05 * r["out_scale"]
    if not out_err <= limit:
        faults.append(f"card outputs off the CPU fp32 path's by {out_err:.4f} > {limit:.4f}")
    for k, ref in losses["cpu"].items():
        if not abs(losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            faults.append(f"{k}: card {losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    return r, faults


def finetune_task_phase(args, task: str, root: str, th_path: str, tok_dir: str, words,
                        image_root: str, dev, smi: str = "") -> dict:
    """One task of phase 9: ``x2vlm_tpu_torch.run --task grounding | nlvr``
    in process, the shipped config with its data paths pointed at files
    written under ``root`` and cut to ``N_FT_STEPS`` steps, from phase 7's
    ``.th``: the steps (each timed and its launches read), the eval (its
    calls timed and read), for grounding a ``--resume`` whose restored
    state must equal the saved one bit for bit; then ``finetune_hold``.
    Returns the phase's launches and those by call."""
    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.tasks import classification as cls_mod, grounding as grounding_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + (9 if task == "grounding" else 10))
    n_images = len(os.listdir(image_root))
    shipped = shipped_config(GROUNDING_CONFIG if task == "grounding" else NLVR_CONFIG)
    cfg = dict(shipped, image_root=image_root, text_encoder=tok_dir)
    if task == "grounding":
        train, test, refs = write_grounding_corpus(root, rng, words, n_images)
        cfg.update(train_file=[train], test_file=[test], refs_file=refs)
        batch, eval_keys = GROUNDING_BATCH, ("val_acc", "testA_acc", "testB_acc")
        eval_mod, eval_name = grounding_mod, "predict_grounding"
    else:
        train, test = write_nlvr_corpus(root, rng, words, n_images)
        cfg.update(train_file=[train], test_file=[test])
        batch, eval_keys = NLVR_BATCH, ("accuracy",)
        eval_mod, eval_name = cls_mod, "evaluate_classification"
    if (cfg["batch_size"], cfg["batch_size_test"], cfg["image_res"]) != \
            (batch, FT_EVAL_BATCH, 384):
        fail(f"{task} launcher: the shipped config's batch sizes / resolution "
             f"{cfg['batch_size']}, {cfg['batch_size_test']}, {cfg['image_res']} changed")
    cfg_path = os.path.join(root, f"{task}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(root, f"out_{task}")
    log(f"phase 9 {task} data and config: {part_done(f'9 {task}', 'data', t0):.1f} s")

    imported, steps, evals = {}, [], []
    orig_load = ckpt_lib.load_reference_checkpoint
    orig_step = run_mod.make_train_step
    orig_eval = getattr(eval_mod, eval_name)

    def load(model, path):
        imported["missing"], imported["unexpected"] = orig_load(model, path)
        return imported["missing"], imported["unexpected"]

    timed = functools.partial(timed_call, args, smi)

    def make_step(model, optimizer, **kw):
        return timed(orig_step(model, optimizer, **kw), steps,
                     f"chip_smoke_{task}_step_profile.txt",
                     lambda i: args.profile and i == N_FT_STEPS - 1)

    evaluate = timed(orig_eval, evals, f"chip_smoke_{task}_eval_profile.txt",
                     lambda i: bool(args.profile))
    argv = ["--task", task, "--config", cfg_path, "--output_dir", out, "--checkpoint", th_path,
            "--epoch", "1", "--seed", str(args.seed), "--device", dev.type]
    t1 = time.perf_counter()
    reset_counts()
    ckpt_lib.load_reference_checkpoint, run_mod.make_train_step = load, make_step
    setattr(eval_mod, eval_name, evaluate)
    try:
        record = run_mod.main(argv)
    finally:
        ckpt_lib.load_reference_checkpoint, run_mod.make_train_step = orig_load, orig_step
        setattr(eval_mod, eval_name, orig_eval)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"phase 9 {task} run ({len(steps)} fine-tune steps + eval): "
        f"{part_done(f'9 {task}', 'run', t1):.1f} s; {json.dumps(record)}")
    step_ms = [[round(r["ms"], 3), round(r["wall_ms"], 3)] for r in steps]
    log(f"phase 9 {task} fine-tune step ms at 384 px, B={batch} (CUDA events, wall): "
        f"{json.dumps(step_ms)}{' (the last one profiled)' if args.profile else ''}; peak "
        f"device memory GiB {[round(r['peak_gib'], 2) for r in steps]}; eval calls (B="
        f"{FT_EVAL_BATCH}) ms (CUDA events, wall) "
        f"{[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in evals]}, eval seconds "
        f"{sum(r['wall_ms'] for r in evals) / 1e3:.3f}, peak GiB "
        f"{[round(r['peak_gib'], 2) for r in evals]}"
        f"{' (profiled)' if args.profile else ''}; {smi}")

    # the import: every parameter the task has from the 224 px .th, but the
    # fresh cls_head of NLVR2; left over what the task does not carry
    missing, unexpected = imported.get("missing"), imported.get("unexpected", [])
    log(f"phase 9 {task} import: missing {missing}, unexpected {len(unexpected)} "
        f"({sorted({'.'.join(k.split('.')[:2]) for k in unexpected})})")
    fresh = [] if task == "grounding" else sorted(
        f"cls_head.{i}.{w}" for i in (0, 1, 3) for w in ("weight", "bias"))
    leftover = ("vision_proj.", "text_proj.", "temp", "itm_head.", "text_encoder.cls.") + \
        (() if task == "grounding" else ("bbox_head.",))
    if missing != fresh or not unexpected or \
            not all(k.startswith(leftover) for k in unexpected) or \
            (task == "nlvr" and "temp" in unexpected):
        fail(f"{task} launcher import of {th_path}: missing {missing}, unexpected {unexpected}")

    vals = [record.get(f"eval_{k}") for k in eval_keys] + [record.get("loss_total")]
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals) or \
            len(steps) != N_FT_STEPS or len(evals) != 1:
        fail(f"{task} launcher: {len(steps)} steps, {len(evals)} evals, record {record}")
    want_step = finetune_step_launches(task, batch, True)
    want_eval = finetune_step_launches(task, FT_EVAL_BATCH, False)
    for i, r in enumerate(steps):
        if r["launches"] != want_step:
            fail(f"{task} launcher step {i}: launches {r['launches']}, expected {want_step}")
    n_eval_calls = N_FT_EVAL // FT_EVAL_BATCH
    want_evals = {"flash_fwd": 12 * n_eval_calls, "flash_bwd": 0, "tiny_bwd": {},
                  "tiny_fwd": {k: n * n_eval_calls for k, n in want_eval["tiny_fwd"].items()}}
    if [r["launches"] for r in evals] != [want_evals]:
        fail(f"{task} launcher eval: launches {[r['launches'] for r in evals]}, expected "
             f"{want_evals}")
    tiny = collections.Counter()
    for shape, n in want_step["tiny_fwd"].items():
        tiny[shape] += n * N_FT_STEPS
    for shape, n in want_eval["tiny_fwd"].items():
        tiny[shape] += n * n_eval_calls
    check_launcher_counts(
        f"{task} launcher", counts, 12 * (N_FT_STEPS + n_eval_calls), 12 * N_FT_STEPS,
        {"tiny_fwd": dict(tiny),
         "tiny_bwd": {k: n * N_FT_STEPS for k, n in want_step["tiny_bwd"].items()}})
    if counts["tiny_walks"]["tiny_attention_fwd"].get(TILED, 0) != \
            sum(n for (b, sq, skv), n in tiny.items() if skv == N_KEYS_384):
        fail(f"{task} launcher: the 40 x {N_KEYS_384} launches are not all key-tiled: "
             f"{counts['tiny_walks']}")

    if task == "grounding":   # --resume: the restored state is the saved one
        saved = torch.load(os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE),
                           map_location="cpu", weights_only=False)
        restored = {}
        orig_restore = ckpt_lib.restore_train_state

        def restore(ckpt_dir, model, optimizer):
            result = orig_restore(ckpt_dir, model, optimizer)
            restored.update(
                params={n: p.detach().cpu() for n, p in model.named_parameters()},
                mu=dict(zip(optimizer.names, (m.cpu() for m in optimizer.mu))),
                nu=dict(zip(optimizer.names, (v.cpu() for v in optimizer.nu))),
                count=optimizer.count)
            return result

        reset_counts()
        t2 = time.perf_counter()
        ckpt_lib.restore_train_state = restore
        try:
            run_mod.main(argv + ["--resume"])
        finally:
            ckpt_lib.restore_train_state = orig_restore
        part_done(f"9 {task}", "resume", t2)
        same = bool(restored) and restored["count"] == saved["count"] and all(
            restored[part].keys() == saved[part].keys() and
            all(torch.equal(restored[part][k], saved[part][k]) for k in saved[part])
            for part in ("params", "mu", "nu"))
        log(f"phase 9 grounding --resume: restored state equal to the saved one bit for bit: "
            f"{same} (step {saved['step']}, count {saved['count']}); launches after it "
            f"{launch_counts()['flash_fwd']} flash (nothing left to train)")
        if not same or launch_counts()["flash_fwd"]:
            fail("grounding launcher --resume: the restored state differs from the saved one, "
                 "or it trained again")
        # the resumed run trained nothing and saved nothing
        del saved, restored

    # the fine-tuned weights on 2 rows, card bf16 against CPU fp32 (deferred)
    train_ds, _ = create_dataset(task, cfg, rng=random.Random(args.seed))
    t_hold = time.perf_counter()
    defer_hold(f"phase 9 {task} card bf16 vs CPU fp32 (2 rows, dropout off)", finetune_hold,
               task, os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE),
               xvlm_config_from_yaml(cfg), [train_ds[0], train_ds[1]], dev)
    part_done(f"9 {task}", "hold", t_hold)
    phase_seconds(f"9 {task}", t0)
    return {"counts": counts, "steps": steps, "evals": evals}


def finetune_launcher_phase(args, root, th_path, tok_dir, words, image_root, dev, smi=""):
    """Phase 9: grounding, then NLVR2. Returns both runs' launch counts,
    split into those of the steps and of the evals (``split_counts``)."""
    out = {ops: {k: collections.Counter() for k in LEDGER_PARTS}
           for ops in ("training", "serving")}
    for task in ("grounding", "nlvr"):
        r = finetune_task_phase(args, task, root, th_path, tok_dir, words, image_root, dev, smi)
        torch.cuda.empty_cache()
        for ops, c in split_counts(r["counts"], [s["delta"] for s in r["steps"]]).items():
            for k in LEDGER_PARTS:
                out[ops][k].update(c[k])
    return out


# ---- phase 10: the launcher's VQA fine-tune at 768 px ----

VQA_CONFIG = "configs/finetune/vqa2_base.yaml"
N_VQA_ANSWERS = 3000                 # the answer list (VQAv2's holds ~3.1k)
VQA_EPOCHS = 2                       # 2 steps an epoch: 4 steps, a save after step 2
N_VQA_TRAIN = 2 * VQA_BATCH          # train questions: 2 steps an epoch
N_VQA_EVAL = 2 * VQA_EVAL_BATCH      # test questions: 2 eval calls
N_VQA_STEPS = VQA_EPOCHS * N_VQA_TRAIN // VQA_BATCH
VQA_RESUME_STEP = N_VQA_TRAIN // VQA_BATCH   # --resume from the state saved after epoch 0


def write_vqa_corpus(root: str, rng: np.random.Generator, words, n_images: int,
                     n_train: int = N_VQA_TRAIN, n_eval: int = N_VQA_EVAL, name: str = "vqa"):
    """An answer list of ``N_VQA_ANSWERS`` distinct answers of 1-3 words and
    VQAv2-style lines over the ``n_images`` PNGs of phase 8 (``n_train`` and
    ``n_eval`` of them, in ``{name}_*.json``): train lines
    with 10 human answers drawn from 3 of the list (merged to count / 10
    weights) or, every fourth, two answers with a ``weight`` field, so a
    batch of 8 has more than 16 answer rows and the seeded cut runs; test
    lines with a ``question_id``, half with 10 human answers and half with
    one. Returns the (train, test, answer list) paths."""
    answers, seen = [], set()
    while len(answers) < N_VQA_ANSWERS:
        a = caption(rng, words, 1, 4)
        if a not in seen:
            seen.add(a)
            answers.append(a)

    def humans():
        pool = [answers[j] for j in rng.choice(N_VQA_ANSWERS, 3, replace=False)]
        return [pool[j] for j in rng.integers(0, 3, 10)], pool

    train = []
    for i in range(n_train):
        line = {"image": f"{i % n_images}.png", "question": caption(rng, words, 4, 14),
                "question_id": i}
        human, pool = humans()
        if i % 4 == 3:
            line.update(answer=pool[:2], weight=[0.6, 0.4])
        else:
            line["answer"] = human
        train.append(line)
    test = []
    for i in range(n_eval):
        human, _ = humans()
        test.append({"image": f"{(i + 7) % n_images}.png", "question_id": 1000 + i,
                     "question": caption(rng, words, 4, 14),
                     "answer": human if i % 2 == 0 else human[:1]})
    paths = [os.path.join(root, f"{name}_{n}.json") for n in ("train", "test", "answers")]
    for path, data in zip(paths, (train, test, answers)):
        with open(path, "w") as f:
            json.dump(data, f)
    return paths


def vqa_launches(train: bool) -> dict:
    """The attention launches of one VQA train step (8 questions, 16 answer
    rows) or eval call (32 questions): 12 flash (the vision pass, S=2305);
    tiny at 40 x 40 (the 12 text layers and the 6 fusion self-attentions)
    and 40 x 2312 (the 6 fusion cross-attentions, key-tiled); the 6 decoder
    layers' cross-attention at 10 x 40 over the answer rows (eval: 1 x 40
    for the first token, 10 x 40 over the 32 x 128 ranked answers) and
    their causal self-attention on the plain core; the backward the same."""
    B = VQA_BATCH if train else VQA_EVAL_BATCH
    dec = ({(VQA_ANSWERS, ANSWER_LEN, TEXT_LEN): 6} if train else
           {(VQA_EVAL_BATCH, 1, TEXT_LEN): 6, (VQA_RANK_ROWS, ANSWER_LEN, TEXT_LEN): 6})
    tiny = {(B, TEXT_LEN, TEXT_LEN): 18, (B, TEXT_LEN, N_KEYS_768): 6, **dec}
    return {"flash_fwd": 12, "flash_bwd": 12 if train else 0, "tiny_fwd": tiny,
            "tiny_bwd": tiny if train else {}, "plain": 6 if train else 12}


def vqa_cosine_params(cfg):
    """Gradients held to the CPU path: the vision tower (K2 / K3, K4), a
    fusion layer's self and cross attention (K6 at 40 x 40 and 40 x 2312), a
    decoder layer's causal self-attention (plain) and cross-attention (K6 at
    10 x 40), and the decoder head."""
    f = f"text_encoder.bert.encoder.layer.{cfg.text.fusion_layer}"
    d = "text_decoder.bert.encoder.layer.0"
    return ("vision_encoder.blocks.0.attn.qkv.weight",
            "vision_encoder.blocks.0.attn.relative_position_bias_table",
            f"{f}.attention.self.query.weight", f"{f}.crossattention.self.key.weight",
            f"{d}.attention.self.query.weight", f"{d}.crossattention.self.key.weight",
            "text_decoder.cls.predictions.transform.dense.weight",
            "text_decoder.cls.predictions.bias")


def no_dropout(mcfg):
    """``mcfg`` with every dropout and drop-path rate at 0."""
    return dataclasses.replace(
        mcfg, vision=dataclasses.replace(mcfg.vision, drop_path_rate=0.0, dropout_rate=0.0,
                                         attn_dropout_rate=0.0),
        text=dataclasses.replace(mcfg.text, hidden_dropout=0.0, attn_dropout=0.0,
                                 text_drop_path_rate=0.0, cross_drop_path_rate=0.0))


def vqa_model(cfg: dict, dtype, device, remat_train: bool):
    """The VQA model of ``cfg`` (no parameters filled): as the factory builds
    it, or with ``remat_train`` its dropouts at 0, to run the loss in
    training mode (its remat on, as ``cfg`` sets it)."""
    from x2vlm_tpu_torch.factory import build_model
    from x2vlm_tpu_torch.models import XVLMForVQA

    if not remat_train:
        return build_model(cfg, "vqa", device=device, dtype=dtype, seed=None)[0]
    return XVLMForVQA(no_dropout(xvlm_config_from_yaml(cfg)),
                      num_dec_layers=cfg.get("num_dec_layers", 6),
                      pad_token_id=cfg.get("pad_token_id", 0), dtype=dtype, device=device,
                      seed=None)


def vqa_hold(state, cfg: dict, batch: dict, answers: dict, dev,
             remat_train: bool = False) -> tuple:
    """The fine-tuned weights ``state`` (or the train state saved at that
    path) on the questions of ``batch`` (their
    answer rows injected), dropout off, the card in bf16 against the port's
    CPU fp32 path: ``loss_vqa`` within 0.05 + 2%, gradient cosines of
    ``vqa_cosine_params`` >= 0.99, each bf16 40 x 2312 forward and backward
    call held on the model's operands within ``FUSION_CALL_RATIO`` of the
    bf16 rule's bound; and ``rank_answer`` over ``answers`` (the answer
    list) with ``K_TEST``: the first answer equal, the top-k scores within
    0.05. The rank takes the question states of the loss pass (one vision
    pass a device). With ``remat_train`` the loss runs in training mode with
    the dropouts at 0 and ``cfg``'s remat (``vqa_model``): each
    rematerialised fusion layer's 40 x 2312 forward runs twice, its forward
    and its recompute, on the card (the CPU fp32 reference runs without
    remat: the same function). Returns the readings and the faults found."""
    from x2vlm_tpu_torch.models.generation import inference

    state = params_of(state)
    names = vqa_cosine_params(xvlm_config_from_yaml(cfg))
    fwd_ratios, bwd_ratios, ranks, losses, grads = [], [], {}, {}, {}
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        # the CPU fp32 reference without remat: remat changes no forward
        # operation, and the CPU's recompute (and dispatch mode) only costs
        model = vqa_model(cfg if tag == "card" else dict(cfg, remat=False), dtype, device,
                          remat_train)
        model.load_state_dict(state)
        b = {k: v.to(device) for k, v in batch.items()}
        model.train(remat_train)
        states, encode = [], model.encode_question

        def kept_encode(*a, **kw):
            states.append(encode(*a, **kw))
            return states[-1]

        model.encode_question = kept_encode
        with held_tiny_calls(N_KEYS_768, fwd_ratios), held_tiny_bwd_calls(N_KEYS_768,
                                                                          bwd_ratios):
            out = model(b)
            out["loss_vqa"].backward()
        with inference(model):
            ids, probs = model.rank_answer(states[0].detach(), b["question_atts"],
                                           answers["answer_ids"].to(device),
                                           answers["answer_atts"].to(device), K_TEST)
        ranks[tag] = (ids.cpu(), probs.float().cpu())
        losses[tag] = out["loss_vqa"].item()
        params = dict(model.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1) for k in names}
        del model, out, b, states
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in names}
    score_err = max_err(ranks["card"][1], ranks["cpu"][1])
    first = {tag: ids[:, 0].tolist() for tag, (ids, _) in ranks.items()}
    r = {"loss_vqa": losses, "cosine": cos, "first_answer": first, "score_err": score_err,
         "cpu_top_scores": ranks["cpu"][1][:, :3].tolist(), "fwd_ratios": fwd_ratios,
         "bwd_ratios": bwd_ratios}
    faults = []
    for kind, ratios, n in (("forward", fwd_ratios, 12 if remat_train else 6),
                            ("backward", bwd_ratios, 6)):
        if len(ratios) != n or not all(x <= FUSION_CALL_RATIO for x in ratios):
            faults.append(f"the 40 x {N_KEYS_768} {kind} calls' errors over the bf16 rule's "
                          f"bound {[round(x, 3) for x in ratios]}, expected {n} at most "
                          f"{FUSION_CALL_RATIO}")
    if not abs(losses["card"] - losses["cpu"]) <= 0.05 + 0.02 * abs(losses["cpu"]):
        faults.append(f"loss_vqa: card {losses['card']:.5f} vs CPU fp32 {losses['cpu']:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    if first["card"] != first["cpu"]:
        faults.append(f"rank_answer's first answers {first['card']} differ from the CPU "
                      f"fp32 path's {first['cpu']}")
    if not score_err <= 0.05:
        faults.append(f"rank_answer's top-k scores off the CPU fp32 path's by {score_err:.4f}")
    return r, faults


def vqa_launcher_phase(args, root: str, th_path: str, tok_dir: str, words, image_root: str,
                       dev, smi: str = "") -> dict:
    """Phase 10: ``x2vlm_tpu_torch.run --task vqa`` in process on
    ``configs/finetune/vqa2_base.yaml`` at its own sizes (768 px, 8
    questions and 16 answer rows a step, 32 questions an eval call, k_test
    128), the data paths pointed at files written under ``root`` over phase
    8's PNGs, cut to 2 epochs of 2 steps with the eval after the last, from
    phase 7's ``.th`` (rel-pos tables interpolated 14 -> 48, the decoder
    fresh): each step and eval call timed and its launches read; then
    ``--resume`` from the state saved at step 2, whose restored state must
    equal the saved one and whose batches (the data cursor and the
    answer-cut rng) must equal the whole run's steps 3 and 4, bit for bit;
    then ``vqa_hold`` on 2 questions. Returns the launches and those by
    call."""
    import hashlib

    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.data.finetune import vqa_collate
    from x2vlm_tpu_torch.models import XVLMForVQA
    from x2vlm_tpu_torch.tasks import vqa as vqa_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 12)
    train, test, answers = write_vqa_corpus(root, rng, words, len(os.listdir(image_root)))
    cfg = dict(shipped_config(VQA_CONFIG), vqa_root=image_root, text_encoder=tok_dir,
               train_file=[train], test_file=[test], answer_list=answers,
               start_eval=VQA_EPOCHS - 1)
    sizes = (cfg["batch_size"], cfg.get("answers_per_batch", 2 * cfg["batch_size"]),
             cfg["answer_max_tokens"], cfg["batch_size_test"], cfg["k_test"], cfg["image_res"],
             cfg["max_tokens"])
    if sizes != (VQA_BATCH, VQA_ANSWERS, ANSWER_LEN, VQA_EVAL_BATCH, K_TEST, 768, TEXT_LEN):
        fail(f"vqa launcher: the shipped config's sizes {sizes} changed")
    cfg_path = os.path.join(root, "vqa.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out, out_resumed = os.path.join(root, "out_vqa"), os.path.join(root, "out_vqa_resumed")
    log(f"phase 10 data and config: {part_done('10', 'data', t0):.1f} s")

    imported, steps, evals, eval_walls = {}, [], [], []
    batches = {"whole": [], "resumed": []}
    run_name = ["whole"]
    orig = {"load": ckpt_lib.load_reference_checkpoint, "save": ckpt_lib.save_train_state,
            "step": run_mod.make_train_step, "to_device": run_mod.to_device,
            "predict": XVLMForVQA.predict, "evaluate": vqa_mod.evaluate_vqa}
    timed = functools.partial(timed_call, args, smi)
    table_key = "vision_encoder.blocks.0.attn.relative_position_bias_table"

    def load(model, path):
        imported["missing"], imported["unexpected"] = orig["load"](model, path)
        imported["decoder"] = sorted(n for n, _ in model.named_parameters()
                                     if n.startswith("text_decoder."))
        src = torch.load(path, map_location="cpu", weights_only=False,
                         mmap=True)["model"][table_key].clone()
        got = model.state_dict()[table_key].cpu().numpy()
        window = lambda rows: int(round((math.sqrt(rows - 3) + 1) / 2))
        want = ckpt_lib.interp_rel_pos_table(src.float().numpy(), window(src.shape[0]),
                                             window(got.shape[0]))
        imported["rel_pos"] = [list(src.shape), list(got.shape),
                               bool(np.array_equal(got, want))]
        return imported["missing"], imported["unexpected"]

    def save(ckpt_dir, model, optimizer, step, data_state=None):
        path = orig["save"](ckpt_dir, model, optimizer, step, data_state)
        if step == VQA_RESUME_STEP and ckpt_dir == os.path.join(out, "ckpt"):
            orig["save"](os.path.join(out_resumed, "ckpt"), model, optimizer, step, data_state)
        return path

    def to_device(batch, device):
        batches[run_name[0]].append({k: hashlib.sha256(np.ascontiguousarray(v)).hexdigest()
                                     for k, v in batch.items()})
        return orig["to_device"](batch, device)

    def make_step(model, optimizer, **kw):
        return timed(orig["step"](model, optimizer, **kw), steps,
                     "chip_smoke_vqa_step_profile.txt",
                     lambda i: args.profile and i == N_VQA_STEPS - 1)

    def evaluate(*a, **kw):
        t = time.perf_counter()
        results = orig["evaluate"](*a, **kw)
        eval_walls.append(time.perf_counter() - t)
        return results

    def patch(on: bool):
        ckpt_lib.load_reference_checkpoint = load if on else orig["load"]
        ckpt_lib.save_train_state = save if on else orig["save"]
        run_mod.make_train_step = make_step if on else orig["step"]
        run_mod.to_device = to_device if on else orig["to_device"]
        vqa_mod.evaluate_vqa = evaluate if on else orig["evaluate"]
        XVLMForVQA.predict = timed(orig["predict"], evals, "chip_smoke_vqa_eval_profile.txt",
                                   lambda i: bool(args.profile) and i == 0) \
            if on else orig["predict"]

    argv = ["--task", "vqa", "--config", cfg_path, "--checkpoint", th_path, "--epoch",
            str(VQA_EPOCHS), "--seed", str(args.seed), "--device", dev.type]
    t1 = time.perf_counter()
    reset_counts()
    patch(True)
    try:
        record = run_mod.main(argv + ["--output_dir", out])
    finally:
        patch(False)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"phase 10 run ({len(steps)} fine-tune steps + eval): "
        f"{part_done('10', 'run', t1):.1f} s; {json.dumps(record)}")
    log(f"phase 10 VQA fine-tune step ms at 768 px, B={VQA_BATCH} questions, {VQA_ANSWERS} "
        f"answer rows (CUDA events, wall): "
        f"{json.dumps([[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in steps])}"
        f"{' (the last one profiled)' if args.profile else ''}; peak device memory GiB "
        f"{[round(r['peak_gib'], 2) for r in steps]}; eval calls (B={VQA_EVAL_BATCH}, k_test "
        f"{K_TEST}: {VQA_RANK_ROWS} ranked rows) ms (CUDA events, wall) "
        f"{[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in evals]}"
        f"{' (the first profiled)' if args.profile else ''}, peak GiB "
        f"{[round(r['peak_gib'], 2) for r in evals]}; eval wall seconds "
        f"{[round(w, 3) for w in eval_walls]} ({N_VQA_EVAL} questions); {smi}")

    # the import: everything but the decoder from the 224 px .th, the tables
    # interpolated 14 -> 48; left over what a VQA model does not carry
    missing, unexpected = imported.get("missing"), imported.get("unexpected", [])
    log(f"phase 10 import: {len(missing or [])} missing (fresh), unexpected {len(unexpected)} "
        f"({sorted({'.'.join(k.split('.')[:2]) for k in unexpected})}); rel-pos table "
        f"(.th shape, model shape, equal to the 14 -> 48 interpolation): "
        f"{imported.get('rel_pos')}")
    leftover = ("vision_proj.", "text_proj.", "temp", "itm_head.", "text_encoder.cls.",
                "bbox_head.")
    if not missing or missing != imported["decoder"] or not unexpected or \
            not all(k.startswith(leftover) for k in unexpected) or \
            imported.get("rel_pos") != [[27 * 27 + 3, 12], [95 * 95 + 3, 12], True]:
        fail(f"vqa launcher import of {th_path}: missing {missing}, unexpected {unexpected}, "
             f"rel-pos {imported.get('rel_pos')}")

    with open(os.path.join(out, "vqa_result.json")) as f:
        results = json.load(f)
    with open(answers) as f:
        answer_set = set(json.load(f))
    vals = [record.get(k) for k in ("eval_overall", "eval_acc", "loss_vqa", "loss_total")]
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals) or \
            len(steps) != N_VQA_STEPS or len(evals) != N_VQA_EVAL // VQA_EVAL_BATCH or \
            record.get("eval_n") != N_VQA_EVAL or len(results) != N_VQA_EVAL or \
            not all(r["answer"] in answer_set for r in results):
        fail(f"vqa launcher: {len(steps)} steps, {len(evals)} eval calls, {len(results)} "
             f"results, record {record}")
    want_step, want_eval = vqa_launches(True), vqa_launches(False)
    for tag, records, want in (("step", steps, want_step), ("eval call", evals, want_eval)):
        for i, r in enumerate(records):
            got = dict(r["launches"], plain=r["plain"])
            if got != want:
                fail(f"vqa launcher {tag} {i}: launches {got}, expected {want}")
    n_eval = len(evals)
    tiny = collections.Counter()
    for want, n in ((want_step, N_VQA_STEPS), (want_eval, n_eval)):
        for shape, k in want["tiny_fwd"].items():
            tiny[shape] += k * n
    check_launcher_counts(
        "vqa launcher", counts, 12 * (N_VQA_STEPS + n_eval), 12 * N_VQA_STEPS,
        {"tiny_fwd": dict(tiny),
         "tiny_bwd": {k: n * N_VQA_STEPS for k, n in want_step["tiny_bwd"].items()}},
        n_plain=want_step["plain"] * N_VQA_STEPS + want_eval["plain"] * n_eval)
    if counts["tiny_walks"]["tiny_attention_fwd"].get(TILED, 0) != \
            sum(n for (b, sq, skv), n in tiny.items() if skv == N_KEYS_768):
        fail(f"vqa launcher: the 40 x {N_KEYS_768} launches are not all key-tiled: "
             f"{counts['tiny_walks']}")

    # --resume from the state saved at step 2: restored bit for bit, and the
    # batches of steps 3 and 4 those of the whole run
    saved = torch.load(os.path.join(out_resumed, "ckpt", ckpt_lib.TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=False)
    restored = {}
    orig_restore = ckpt_lib.restore_train_state

    def restore(ckpt_dir, model, optimizer):
        result = orig_restore(ckpt_dir, model, optimizer)
        copy = lambda t: t.detach().to("cpu", copy=True)   # the run goes on in place
        restored.update(params={n: copy(p) for n, p in model.named_parameters()},
                        mu=dict(zip(optimizer.names, map(copy, optimizer.mu))),
                        nu=dict(zip(optimizer.names, map(copy, optimizer.nu))),
                        count=optimizer.count)
        return result

    t2 = time.perf_counter()
    run_name[0] = "resumed"
    steps_before = len(steps)
    ckpt_lib.restore_train_state = restore
    patch(True)
    try:
        run_mod.main(argv + ["--output_dir", out_resumed, "--resume"])
    finally:
        patch(False)
        ckpt_lib.restore_train_state = orig_restore
    same = bool(restored) and saved["step"] == VQA_RESUME_STEP and \
        restored["count"] == saved["count"] and all(
            restored[part].keys() == saved[part].keys() and
            all(torch.equal(restored[part][k], saved[part][k]) for k in saved[part])
            for part in ("params", "mu", "nu"))
    same_batches = batches["resumed"] == batches["whole"][VQA_RESUME_STEP:]
    log(f"phase 10 --resume from step {saved['step']}: {part_done('10', 'resume', t2):.1f} s; "
        f"restored state equal to the saved one bit for bit: {same}; its "
        f"{len(batches['resumed'])} batches equal to the whole run's steps "
        f"{VQA_RESUME_STEP + 1}-{N_VQA_STEPS} bit for bit: {same_batches} "
        f"({len(steps) - steps_before} steps)")
    if not same or not same_batches or len(steps) - steps_before != \
            N_VQA_STEPS - VQA_RESUME_STEP:
        fail("vqa launcher --resume: the restored state or the batches after it differ from "
             "the whole run's")
    del saved, restored
    steps = steps[:steps_before]
    evals = evals[:n_eval]

    # the fine-tuned weights on 2 questions, card bf16 against CPU fp32 (deferred)
    train_ds, test_ds = create_dataset("vqa", cfg, rng=random.Random(args.seed))
    batch = vqa_collate([train_ds[0], train_ds[1]], 4, rng=random.Random(args.seed))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("question_ids", "answer_ids", "answer_index"):
        batch[k] = batch[k].long()
    t_hold = time.perf_counter()
    defer_hold("phase 10 card bf16 vs CPU fp32 (2 questions, 4 answer rows, dropout off)",
               vqa_hold, os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE), cfg, batch,
               {"answer_ids": torch.from_numpy(test_ds.answer_ids).long(),
                "answer_atts": torch.from_numpy(test_ds.answer_atts)}, dev)
    part_done("10", "hold", t_hold)
    phase_seconds("10", t0)
    return split_counts(counts, [r["delta"] for r in steps])


CAPTION_CONFIG = "configs/finetune/coco_captioning_base.yaml"
CAP_EPOCHS = 2                       # 2 steps an epoch: 4 steps, a save after step 2
N_CAP_TRAIN = 2 * CAP_BATCH          # train images: 2 steps an epoch (and 2 SCST steps)
N_CAP_EVAL = 2 * CAP_EVAL_BATCH      # test images: 2 eval calls
N_CAP_STEPS = CAP_EPOCHS * N_CAP_TRAIN // CAP_BATCH
CAP_RESUME_STEP = N_CAP_TRAIN // CAP_BATCH   # --resume from the state saved after epoch 0
N_SCST_STEPS = N_CAP_TRAIN // CAP_BATCH
CAP_LOGIT_RULE = (0.05, 0.05)        # phase 9's logits rule: 0.05 + 5% of their scale
# the SCST hold's advantages, 5 rollouts of each of 2 images: planted, since
# with random weights every CIDEr-D reward of the launcher's run is 0
SCST_HOLD_ADV = np.array([0.7, -1.2, 0.4, -0.3, 1.1, -0.5, 0.9, -0.8, 0.2, -0.6], np.float32)


def write_caption_corpus(root: str, rng: np.random.Generator, words, n_images: int,
                         n_train: int = N_CAP_TRAIN, n_test: int = N_CAP_EVAL,
                         name: str = "caption"):
    """Karpathy-style lines over the ``n_images`` PNGs of phase 8: ``n_train``
    train lines, one an image with its 5 captions (the train set draws one
    a read; the SCST set takes all 5 as references); ``n_test`` test lines,
    an ``image_id`` and 5 captions a line; and the ``caption_gt_file`` of
    the test images. Returns the (train, test, gt) paths."""
    caps = lambda: [caption(rng, words, 5, 16) for _ in range(5)]
    train = [{"image": f"{i % n_images}.png", "caption": caps(), "image_id": i}
             for i in range(n_train)]
    test = [{"image": f"{(i + 11) % n_images}.png", "caption": caps(), "image_id": 5000 + i}
            for i in range(n_test)]
    gt = {str(line["image_id"]): line["caption"] for line in test}
    paths = [os.path.join(root, f"{name}_{n}.json") for n in ("train", "test", "gt")]
    for path, data in zip(paths, (train, test, gt)):
        with open(path, "w") as f:
            json.dump(data, f)
    return paths


def caption_launches(kind: str) -> dict:
    """The attention launches of one captioning train step ("step", 16
    images), eval call ("eval": 16 images, 3 beams), SCST rollout call
    ("rollout": 16 images x 5 rollouts) or SCST step ("scst": 80 rows): 12
    flash (the vision pass, S=577); tiny only for the 6 fusion
    cross-attentions, key-tiled at 584 keys (a decode: frame 0 at the
    prompt's 5 queries, then 19 frames of 2 over the expanded rows); the 18
    text self-attentions on the plain core, once a step (the UniLM attention
    matrix) or once a frame (the static cache); the backward as the
    forward in training."""
    train = kind in ("step", "scst")
    if train:
        rows, sq = (CAP_BATCH, CAP_TOKENS) if kind == "step" else (SCST_ROWS, SCST_LEN)
        tiny, plain = {(rows, sq, N_KEYS_384): 6}, 18
    else:
        first, rows = ((CAP_EVAL_BATCH, CAP_BEAMS * CAP_EVAL_BATCH) if kind == "eval"
                       else (SCST_ROWS, SCST_ROWS))
        tiny = {(first, CAP_PROMPT + 1, N_KEYS_384): 6,
                (rows, 2, N_KEYS_384): 6 * (CAP_MAX_LEN - 1)}
        plain = 18 * CAP_MAX_LEN
    return {"flash_fwd": 12, "flash_bwd": 12 if train else 0, "tiny_fwd": tiny,
            "tiny_bwd": tiny if train else {}, "plain": plain}


def caption_cosine_params(cfg):
    """Gradients held to the CPU path: the vision tower (K2 / K3, K4), a
    fusion layer's masked self-attention (plain) and cross-attention (K6 at
    25 x 584), and the MLM head."""
    f = f"text_encoder.bert.encoder.layer.{cfg.text.fusion_layer}"
    return ("vision_encoder.blocks.0.attn.qkv.weight",
            "vision_encoder.blocks.0.attn.relative_position_bias_table",
            f"{f}.attention.self.query.weight", f"{f}.crossattention.self.key.weight",
            "text_encoder.cls.predictions.transform.dense.weight",
            "text_encoder.cls.predictions.bias")


def caption_hold(state, cfg: dict, batch: dict, sampled: list, prompt: list, tok,
                 dev) -> tuple:
    """The fine-tuned weights ``state`` (or the train state saved at that
    path) on the 2 images of ``batch``, dropout
    off, the card in bf16 against the port's CPU fp32 path: ``loss_caption``
    and ``loss_scst`` (the SCST step's batch of ``build_scst_batch`` over
    the captions ``sampled``, 5 an image, weighted by ``SCST_HOLD_ADV``)
    each within 0.05 + 2%, the gradient cosines of
    ``caption_cosine_params`` of each >= 0.99, each bf16 x 584 forward and
    backward call of both (25 and 46 queries) held on the model's operands
    within ``FUSION_CALL_RATIO`` of the bf16 rule's bound; a
    teacher-forced decode (each frame fed the CPU path's greedy token) whose
    logits stay within ``CAP_LOGIT_RULE`` of the CPU's, frame 0's top-3 ids
    equal; and the beam search's captions of both (compared, not held).
    Returns the readings and the faults found."""
    state = params_of(state)
    from x2vlm_tpu_torch.factory import build_model
    from x2vlm_tpu_torch.models.captioning import beam_search_generate_device
    from x2vlm_tpu_torch.models.generation import top_k
    from x2vlm_tpu_torch.tasks.scst import build_scst_batch

    names = caption_cosine_params(xvlm_config_from_yaml(cfg))
    keys = ("loss_caption", "loss_scst")
    ratios = {(key, kind): [] for key in keys for kind in ("forward", "backward")}
    losses, grads = {key: {} for key in keys}, {key: {} for key in keys}
    logits, top3, captions, cpu_tokens = {}, {}, {}, []
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        model, _ = build_model(cfg, "captioning", device=device, dtype=dtype, seed=None)
        model.load_state_dict(state)
        b = {k: v.to(device) for k, v in batch.items()}
        scst_batch = build_scst_batch(b["image"], sampled, SCST_HOLD_ADV, prompt,
                                      mask_token_id=tok.mask_token_id,
                                      sep_token_id=tok.sep_token_id,
                                      pad_token_id=tok.pad_token_id, max_length=CAP_MAX_LEN)
        params = dict(model.named_parameters())
        for key, inputs in zip(keys, (b, scst_batch)):
            with held_tiny_calls(N_KEYS_384, ratios[key, "forward"]), \
                    held_tiny_bwd_calls(N_KEYS_384, ratios[key, "backward"]):
                out = model(inputs)
                out[key].backward()
            losses[key][tag] = out[key].item()
            grads[key][tag] = {k: params[k].grad.detach().double().cpu().reshape(-1)
                               for k in names}
            del out
            model.zero_grad(set_to_none=True)
        del params, scst_batch
        with torch.no_grad():
            emb, atts = model.encode_image(b["image"])
            cache = model.init_cache(2, CAP_PROMPT + CAP_MAX_LEN + 1)
            x = torch.tensor([prompt + [tok.mask_token_id]] * 2, device=device)
            frames = []
            for t in range(CAP_MAX_LEN):
                lg, cache = model.decode_step(x, 0 if t == 0 else CAP_PROMPT + t - 1, cache,
                                              emb, atts)
                frames.append(lg.float().cpu())
                if tag == "cpu":
                    cpu_tokens.append(lg.argmax(-1))
                x = torch.stack([cpu_tokens[t].to(device),
                                 torch.full((2,), tok.mask_token_id, device=device)], 1)
            logits[tag] = torch.stack(frames)
            top3[tag] = top_k(torch.log_softmax(frames[0], -1), 3)[1].tolist()
            captions[tag] = [tok.decode(c, skip_special_tokens=True) for c in
                             beam_search_generate_device(
                                 model, b["image"], prompt, mask_token_id=tok.mask_token_id,
                                 eos_token_id=tok.sep_token_id, num_beams=CAP_BEAMS,
                                 min_length=cfg["min_length"], max_length=CAP_MAX_LEN)]
        del model, b, cache, emb, atts
    torch.cuda.empty_cache()
    cos = {key: {k: F.cosine_similarity(grads[key]["card"][k], grads[key]["cpu"][k],
                                        dim=0).item() for k in names} for key in keys}
    logit_err = max_err(logits["card"], logits["cpu"])
    logit_bound = CAP_LOGIT_RULE[0] + CAP_LOGIT_RULE[1] * logits["cpu"].abs().max().item()
    r = {"losses": losses, "cosine": cos, "logit_err": logit_err,
         "logit_bound": logit_bound, "frame0_top3": top3, "captions": captions,
         "captions_equal": captions["card"] == captions["cpu"],
         "call_ratios": {f"{key} {kind}": v for (key, kind), v in ratios.items()}}
    faults = []
    for (key, kind), got in ratios.items():
        sq = CAP_TOKENS if key == "loss_caption" else SCST_LEN
        if len(got) != 6 or not all(x <= FUSION_CALL_RATIO for x in got):
            faults.append(f"{key}: the {sq} x {N_KEYS_384} {kind} calls' errors over the bf16 "
                          f"rule's bound {[round(x, 3) for x in got]}, expected 6 at most "
                          f"{FUSION_CALL_RATIO}")
    for key in keys:
        card, cpu = losses[key]["card"], losses[key]["cpu"]
        if not abs(card - cpu) <= 0.05 + 0.02 * abs(cpu):
            faults.append(f"{key}: card {card:.5f} vs CPU fp32 {cpu:.5f}")
        for k, c in cos[key].items():
            if not c >= 0.99:
                faults.append(f"{key} gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    if not logit_err <= logit_bound:
        faults.append(f"teacher-forced decode logits off the CPU fp32 path's by "
                      f"{logit_err:.4f} > {logit_bound:.4f}")
    if top3["card"] != top3["cpu"]:
        faults.append(f"frame 0's top-3 ids {top3['card']} differ from the CPU fp32 path's "
                      f"{top3['cpu']}")
    return r, faults


def caption_launcher_phase(args, root: str, th_path: str, tok_dir: str, words,
                           image_root: str, dev, smi: str = "") -> list:
    """Phase 11: ``x2vlm_tpu_torch.run --task captioning`` in process on
    ``configs/finetune/coco_captioning_base.yaml`` at its own sizes (384 px,
    16 images a step and an eval call, 25 tokens, 12 masks, beams 3,
    captions of 5 to 20 tokens after the prompt "a picture of "), the data
    paths pointed at files written under ``root`` over phase 8's PNGs, cut
    to 2 epochs of 2 steps with the eval of 32 images after the last, from
    phase 7's ``.th`` (rel-pos tables interpolated 14 -> 24): each step and
    eval call timed and its launches read; ``--resume`` from the state saved
    at step 2 (restored state and the batches of steps 3 and 4 equal to the
    whole run's, bit for bit); ``scst: true`` from the fine-tuned state, 2
    steps of 16 images x 5 rollouts (each rollout call and step timed and
    read); then ``caption_hold`` on 2 images. Returns the launches of the
    two runs, each split by operands."""
    import hashlib

    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.data.loader import collate
    from x2vlm_tpu_torch.data.tokenization import build_tokenizer
    from x2vlm_tpu_torch.tasks import captioning as cap_mod, scst as scst_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 13)
    train, test, gt = write_caption_corpus(root, rng, words, len(os.listdir(image_root)))
    cfg = dict(shipped_config(CAPTION_CONFIG), image_root=image_root, text_encoder=tok_dir,
               train_file=[train], test_file=[test], caption_gt_file=gt,
               start_eval=CAP_EPOCHS - 1)
    sizes = (cfg["batch_size"], cfg["batch_size_test"], cfg["max_tokens"], cfg["num_beams"],
             cfg["max_length"], cfg["image_res"])
    if sizes != (CAP_BATCH, CAP_EVAL_BATCH, CAP_TOKENS, CAP_BEAMS, CAP_MAX_LEN, 384):
        fail(f"caption launcher: the shipped config's sizes {sizes} changed")
    tok = build_tokenizer(tok_dir)
    prompt = cap_mod.prompt_ids(tok, cfg["prompt"])
    if len(prompt) != CAP_PROMPT:
        fail(f"caption launcher: the prompt {cfg['prompt']!r} is {len(prompt)} tokens with "
             f"this vocab, the shapes of phase 2 assume {CAP_PROMPT}")
    cfg_path, scst_path = os.path.join(root, "caption.json"), os.path.join(root, "scst.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    scst_cfg = {k: v for k, v in cfg.items() if k != "caption_gt_file"}
    scst_cfg.update(scst=True, batch_size_scst=CAP_BATCH, scst_num_samples=SCST_SAMPLES)
    with open(scst_path, "w") as f:
        json.dump(scst_cfg, f)
    out, out_resumed = os.path.join(root, "out_cap"), os.path.join(root, "out_cap_resumed")
    out_scst = os.path.join(root, "out_scst")
    log(f"phase 11 data and config: {part_done('11', 'data', t0):.1f} s")

    imported, steps, evals, rollouts, eval_walls = {}, [], [], [], []
    step_sink = [steps]        # the list the timed train steps go to
    batches = {"whole": [], "resumed": []}
    run_name = ["whole"]
    orig = {"load": ckpt_lib.load_reference_checkpoint, "save": ckpt_lib.save_train_state,
            "step": run_mod.make_train_step, "to_device": run_mod.to_device,
            "search": cap_mod.beam_search_generate_device,
            "generate": cap_mod.generate_captions,
            "rollout": scst_mod.sample_generate_captioning}
    timed = functools.partial(timed_call, args, smi)
    table_key = "vision_encoder.blocks.0.attn.relative_position_bias_table"

    def load(model, path):
        imported["missing"], imported["unexpected"] = orig["load"](model, path)
        src = torch.load(path, map_location="cpu", weights_only=False,
                         mmap=True)["model"][table_key].clone()
        got = model.state_dict()[table_key].cpu().numpy()
        window = lambda rows: int(round((math.sqrt(rows - 3) + 1) / 2))
        want = ckpt_lib.interp_rel_pos_table(src.float().numpy(), window(src.shape[0]),
                                             window(got.shape[0]))
        imported["rel_pos"] = [list(src.shape), list(got.shape),
                               bool(np.array_equal(got, want))]
        return imported["missing"], imported["unexpected"]

    def link(src_dir, dst_dir):
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, ckpt_lib.TRAIN_STATE_FILE)
        if os.path.exists(dst):
            os.remove(dst)
        os.link(os.path.join(src_dir, ckpt_lib.TRAIN_STATE_FILE), dst)
        return dst

    def save(ckpt_dir, model, optimizer, step, data_state=None):
        # an X2VLM-base train state is ~3.4 GB and the script's disk writes
        # add up over its phases: the best epoch's copy and the resume's
        # start are hard links, and the resumed run (held in memory) writes
        # none
        if run_name[0] == "resumed":
            return None
        if ckpt_dir.endswith("ckpt_best"):
            return link(os.path.join(os.path.dirname(ckpt_dir), "ckpt"), ckpt_dir)
        path = orig["save"](ckpt_dir, model, optimizer, step, data_state)
        if step == CAP_RESUME_STEP and ckpt_dir == os.path.join(out, "ckpt"):
            link(ckpt_dir, os.path.join(out_resumed, "ckpt"))
        return path

    def to_device(batch, device):
        batches[run_name[0]].append({k: hashlib.sha256(np.ascontiguousarray(v)).hexdigest()
                                     for k, v in batch.items()})
        return orig["to_device"](batch, device)

    def make_step(model, optimizer, **kw):
        return timed(orig["step"](model, optimizer, **kw), step_sink[0],
                     "chip_smoke_captioning_step_profile.txt",
                     lambda i: args.profile and i == N_CAP_STEPS - 1)

    def generate(*a, **kw):
        t = time.perf_counter()
        results = orig["generate"](*a, **kw)
        eval_walls.append(time.perf_counter() - t)
        return results

    def patch(on: bool):
        ckpt_lib.load_reference_checkpoint = load if on else orig["load"]
        ckpt_lib.save_train_state = save if on else orig["save"]
        run_mod.make_train_step = make_step if on else orig["step"]
        run_mod.to_device = to_device if on else orig["to_device"]
        cap_mod.generate_captions = generate if on else orig["generate"]
        cap_mod.beam_search_generate_device = timed(
            orig["search"], evals, "chip_smoke_captioning_eval_profile.txt",
            lambda i: bool(args.profile) and i == 0) if on else orig["search"]
        scst_mod.sample_generate_captioning = timed(
            orig["rollout"], rollouts, "", lambda i: False) if on else orig["rollout"]

    argv = ["--task", "captioning", "--seed", str(args.seed), "--device", dev.type]
    t1 = time.perf_counter()
    reset_counts()
    patch(True)
    try:
        record = run_mod.main(argv + ["--config", cfg_path, "--checkpoint", th_path,
                                      "--epoch", str(CAP_EPOCHS), "--output_dir", out])
    finally:
        patch(False)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"phase 11 run ({len(steps)} fine-tune steps + eval): "
        f"{part_done('11', 'run', t1):.1f} s; {json.dumps(record)}")
    log(f"phase 11 captioning step ms at 384 px, B={CAP_BATCH} (CUDA events, wall): "
        f"{json.dumps([[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in steps])}"
        f"{' (the last one profiled)' if args.profile else ''}; peak device memory GiB "
        f"{[round(r['peak_gib'], 2) for r in steps]}; eval calls (B={CAP_EVAL_BATCH}, "
        f"{CAP_BEAMS} beams, {CAP_MAX_LEN} frames) ms (CUDA events, wall) "
        f"{[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in evals]}"
        f"{' (the first profiled)' if args.profile else ''}, peak GiB "
        f"{[round(r['peak_gib'], 2) for r in evals]}; eval wall seconds "
        f"{[round(w, 3) for w in eval_walls]} ({N_CAP_EVAL} images); {smi}")

    # the import: every parameter from the 224 px .th, the tables
    # interpolated 14 -> 24; left over what a captioning model does not carry
    missing, unexpected = imported.get("missing"), imported.get("unexpected", [])
    log(f"phase 11 import: {len(missing or [])} missing (fresh), unexpected {len(unexpected)} "
        f"({sorted({'.'.join(k.split('.')[:2]) for k in unexpected})}); rel-pos table "
        f"(.th shape, model shape, equal to the 14 -> 24 interpolation): "
        f"{imported.get('rel_pos')}")
    leftover = ("vision_proj.", "text_proj.", "temp", "itm_head.", "bbox_head.",
                "text_encoder.cls.predictions.decoder.")
    if missing != [] or not unexpected or not all(k.startswith(leftover) for k in unexpected) \
            or imported.get("rel_pos") != [[27 * 27 + 3, 12], [47 * 47 + 3, 12], True]:
        fail(f"caption launcher import of {th_path}: missing {missing}, unexpected "
             f"{unexpected}, rel-pos {imported.get('rel_pos')}")

    metrics = ("eval_bleu1", "eval_bleu4", "eval_cider", "eval_rouge_l", "eval_meteor",
               "loss_caption", "loss_total")
    vals = [record.get(k) for k in metrics]
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals) or \
            len(steps) != N_CAP_STEPS or len(evals) != N_CAP_EVAL // CAP_EVAL_BATCH or \
            record.get("eval_n") != N_CAP_EVAL:
        fail(f"caption launcher: {len(steps)} steps, {len(evals)} eval calls, record {record}")
    want = {k: caption_launches(k) for k in ("step", "eval", "rollout", "scst")}
    for tag, records, w in (("step", steps, want["step"]), ("eval call", evals, want["eval"])):
        for i, r in enumerate(records):
            got = dict(r["launches"], plain=r["plain"])
            if got != w:
                fail(f"caption launcher {tag} {i}: launches {got}, expected {w}")

    def check_run(tag, c, parts):
        tiny_f, tiny_b = collections.Counter(), collections.Counter()
        for kind, n in parts:
            for shape, k in want[kind]["tiny_fwd"].items():
                tiny_f[shape] += k * n
            for shape, k in want[kind]["tiny_bwd"].items():
                tiny_b[shape] += k * n
        check_launcher_counts(
            tag, c, sum(12 * n for _, n in parts),
            sum(want[kind]["flash_bwd"] * n for kind, n in parts),
            {"tiny_fwd": dict(tiny_f), "tiny_bwd": dict(tiny_b)},
            n_plain=sum(want[kind]["plain"] * n for kind, n in parts))
        if c["tiny_walks"]["tiny_attention_fwd"].get(TILED, 0) != sum(tiny_f.values()) or \
                c["tiny_walks"]["tiny_attention_bwd"].get(TILED, 0) != sum(tiny_b.values()):
            fail(f"{tag}: the x {N_KEYS_384} launches are not all key-tiled: "
                 f"{c['tiny_walks']}")

    n_eval = len(evals)
    check_run("caption launcher", counts, (("step", N_CAP_STEPS), ("eval", n_eval)))

    # --resume from the state saved at step 2: restored bit for bit, and the
    # batches of steps 3 and 4 those of the whole run
    saved = torch.load(os.path.join(out_resumed, "ckpt", ckpt_lib.TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=False)
    restored = {}
    orig_restore = ckpt_lib.restore_train_state

    def restore(ckpt_dir, model, optimizer):
        result = orig_restore(ckpt_dir, model, optimizer)
        copy = lambda t: t.detach().to("cpu", copy=True)   # the run goes on in place
        restored.update(params={n: copy(p) for n, p in model.named_parameters()},
                        mu=dict(zip(optimizer.names, map(copy, optimizer.mu))),
                        nu=dict(zip(optimizer.names, map(copy, optimizer.nu))),
                        count=optimizer.count)
        return result

    t2 = time.perf_counter()
    run_name[0] = "resumed"
    steps_before, evals_before = len(steps), len(evals)
    ckpt_lib.restore_train_state = restore
    patch(True)
    try:
        run_mod.main(argv + ["--config", cfg_path, "--checkpoint", th_path, "--epoch",
                             str(CAP_EPOCHS), "--output_dir", out_resumed, "--resume"])
    finally:
        patch(False)
        ckpt_lib.restore_train_state = orig_restore
    same = bool(restored) and saved["step"] == CAP_RESUME_STEP and \
        restored["count"] == saved["count"] and all(
            restored[part].keys() == saved[part].keys() and
            all(torch.equal(restored[part][k], saved[part][k]) for k in saved[part])
            for part in ("params", "mu", "nu"))
    same_batches = batches["resumed"] == batches["whole"][CAP_RESUME_STEP:]
    log(f"phase 11 --resume from step {saved['step']}: {part_done('11', 'resume', t2):.1f} s; "
        f"restored state equal to the saved one bit for bit: {same}; its "
        f"{len(batches['resumed'])} batches equal to the whole run's steps "
        f"{CAP_RESUME_STEP + 1}-{N_CAP_STEPS} bit for bit: {same_batches} "
        f"({len(steps) - steps_before} steps)")
    if not same or not same_batches or len(steps) - steps_before != \
            N_CAP_STEPS - CAP_RESUME_STEP:
        fail("caption launcher --resume: the restored state or the batches after it differ "
             "from the whole run's")
    del saved, restored
    steps, evals = steps[:steps_before], evals[:evals_before]

    # scst: true from the fine-tuned state: 2 steps of 16 images x 5 rollouts
    t3 = time.perf_counter()
    scst_steps = []
    step_sink[0] = scst_steps
    run_name[0] = "scst"
    reset_counts()
    patch(True)
    try:
        scst_record = run_mod.main(argv + ["--config", scst_path, "--checkpoint",
                                           os.path.join(out, "ckpt"), "--epoch", "1",
                                           "--output_dir", out_scst])
    finally:
        patch(False)
    torch.cuda.synchronize()
    scst_counts = launch_counts()
    log(f"phase 11 SCST ({len(scst_steps)} steps of {CAP_BATCH} images x {SCST_SAMPLES} "
        f"rollouts): {part_done('11', 'run', t3):.1f} s; {json.dumps(scst_record)}; rollout "
        f"calls ms (CUDA events, wall) "
        f"{[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in rollouts]}, peak GiB "
        f"{[round(r['peak_gib'], 2) for r in rollouts]}; SCST step ms (CUDA events, wall) "
        f"{[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in scst_steps]}, peak GiB "
        f"{[round(r['peak_gib'], 2) for r in scst_steps]}; {smi}")
    if len(scst_steps) != N_SCST_STEPS or len(rollouts) != N_SCST_STEPS or \
            not math.isfinite(scst_record.get("loss_scst", float("nan"))):
        fail(f"caption launcher scst: {len(scst_steps)} steps, {len(rollouts)} rollout "
             f"calls, record {scst_record}")
    for tag, records, w in (("SCST rollout call", rollouts, want["rollout"]),
                            ("SCST step", scst_steps, want["scst"])):
        for i, r in enumerate(records):
            got = dict(r["launches"], plain=r["plain"])
            if got != w:
                fail(f"caption launcher {tag} {i}: launches {got}, expected {w}")
    check_run("caption launcher scst", scst_counts,
              (("rollout", len(rollouts)), ("scst", len(scst_steps))))

    # the fine-tuned weights on 2 images, card bf16 against CPU fp32 (deferred)
    train_ds, _ = create_dataset("captioning", cfg, tokenizer=tok,
                                 rng=random.Random(args.seed))
    batch = run_mod.to_device(collate([train_ds[0], train_ds[1]]), torch.device("cpu"))
    # the SCST batch's captions: the 5 references of each of the 2 images
    with open(train) as f:
        lines = json.load(f)[:2]
    sampled = [tok.convert_tokens_to_ids(tok.tokenize(c))[:CAP_MAX_LEN]
               for line in lines for c in line["caption"]]
    t_hold = time.perf_counter()
    defer_hold("phase 11 card bf16 vs CPU fp32 (2 images, dropout off)", caption_hold,
               os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE), cfg, batch, sampled, prompt,
               tok, dev)
    part_done("11", "hold", t_hold)
    phase_seconds("11", t0)
    return [split_counts(counts, [r["delta"] for r in steps]),
            split_counts(scst_counts, [r["delta"] for r in scst_steps])]


# ---- phase 12: the launcher's retrieval task on the CLIP ViT and Swin towers ----

TOWER_CONFIGS = {"clip": "configs/finetune/retrieval_flickr_clip_base.yaml",
                 "swin": "configs/finetune/retrieval_flickr_swin_base.yaml"}
N_TOWER_STEPS = 2                    # phase 12: fine-tune steps a tower (64 captions, B=32)
TOWER_EVAL_BATCH = 64                # the YAMLs' batch_size_test: the eval's image calls
N_SWIN_WINDOW_CALLS = 24             # Swin-B's 2 + 2 + 18 + 2 window attentions a forward


def tower_keys(tower: str) -> int:
    """The fusion's image keys at 224 px once padded to 8: CLIP's 197 ->
    200, Swin's 50 -> 56."""
    n = N_IMG_SWIN if tower == "swin" else N_IMG
    return n + (-n % 8)


def tower_call_launches(tower: str, kind: str) -> dict:
    """The attention launches of one phase-12 call (``call_launches`` and
    the plain attention's): a fine-tune ``step`` (B=32: the vision pass,
    12 text layers, the ITM fusion pass over 3 x 32 rows; the backward the
    same), an ``eval`` (one image call of 64, two text calls of 256, the
    rerank's 8 calls of 1024 rows and 40 of 512), or the requests at B=128
    (``encode_images``, ``encode_texts``, ``itm_score``). CLIP's vision
    pass is 12 flash launches without a bias (no dBias), Swin's 24 window
    attentions on the plain core."""
    K, clip = tower_keys(tower), tower == "clip"
    n_img = {"step": TRAIN_BATCH, "eval": TOWER_EVAL_BATCH, "encode_images": BATCH}.get(kind)
    tiny = {"step": {(TRAIN_BATCH, TEXT_LEN, TEXT_LEN): 12,
                     (3 * TRAIN_BATCH, TEXT_LEN, TEXT_LEN): 6,
                     (3 * TRAIN_BATCH, TEXT_LEN, K): 6},
            "eval": {(256, TEXT_LEN, TEXT_LEN): 12 * 2,
                     (RERANK_BATCH, TEXT_LEN, TEXT_LEN): 6 * (N_LAUNCH_IMAGES // 8),
                     (RERANK_BATCH, TEXT_LEN, K): 6 * (N_LAUNCH_IMAGES // 8),
                     (RERANK_BATCH // 2, TEXT_LEN, TEXT_LEN): 6 * (5 * N_LAUNCH_IMAGES // 8),
                     (RERANK_BATCH // 2, TEXT_LEN, K): 6 * (5 * N_LAUNCH_IMAGES // 8)},
            "encode_images": {},
            "encode_texts": {(BATCH, TEXT_LEN, TEXT_LEN): 12},
            "itm_score": {(BATCH, TEXT_LEN, TEXT_LEN): 6, (BATCH, TEXT_LEN, K): 6}}[kind]
    train = kind == "step"
    return {"flash_fwd": 12 if clip and n_img else 0,
            "flash_bwd": 12 if clip and train else 0, "tiny_fwd": tiny,
            "tiny_bwd": tiny if train else {},
            "plain": 0 if clip or not n_img else N_SWIN_WINDOW_CALLS}


def tower_cosine_params(cfg, tower: str):
    """Gradients held to the CPU path: CLIP's first layer's q / k
    projections (K2 / K3) or a shifted Swin block's qkv and window table
    (the plain window attention), a fusion layer's self and cross attention
    (K6, 40 x 40 and 40 x 200 / 56) and the ITM head."""
    f = f"text_encoder.bert.encoder.layer.{cfg.text.fusion_layer}"
    vision = (("vision_encoder.encoder.layers.0.self_attn.q_proj.weight",
               "vision_encoder.encoder.layers.0.self_attn.k_proj.weight")
              if tower == "clip" else
              ("vision_encoder.layers.0.blocks.1.attn.qkv.weight",
               "vision_encoder.layers.0.blocks.1.attn.relative_position_bias_table",
               "vision_encoder.layers.2.blocks.1.attn.qkv.weight"))
    return vision + (f"{f}.attention.self.query.weight", f"{f}.crossattention.self.key.weight",
                     "itm_head.0.weight", "itm_head.3.weight")


def tower_hold(tower: str, state: dict, mcfg, batch: dict, dev):
    """The fine-tuned weights on 2 rows in eval mode (dropout and drop path
    off), the hard negatives injected: the card in bf16 against the port's
    CPU fp32 path: ITC and ITM within 0.05 + 2%, gradient cosines of
    ``tower_cosine_params`` >= 0.99, each bf16 40 x 200 / 56 fusion call
    into the tiny forward and backward held on the model's operands to the
    plain version (``FUSION_CALL_RATIO``). Returns (readings, faults)."""
    K = tower_keys(tower)
    names = tower_cosine_params(mcfg, tower)
    neg = (torch.tensor([1, 0]), torch.tensor([1, 0]))
    fwd_ratios, bwd_ratios, losses, grads = [], [], {}, {}
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        model = XVLMForRetrieval(mcfg, dtype=dtype, device=device, seed=None)
        model.load_state_dict(state)
        b = {k: v.to(device) for k, v in batch.items()}
        with held_tiny_calls(K, fwd_ratios), held_tiny_bwd_calls(K, bwd_ratios):
            out = model(b, neg_idx=tuple(n.to(device) for n in neg))
            sum(out.values()).backward()
        losses[tag] = {k: v.item() for k, v in out.items()}
        params = dict(model.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1) for k in names}
        del model
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in names}
    r = {"losses": losses, "cosine": cos, "fwd_ratios": fwd_ratios, "bwd_ratios": bwd_ratios}
    faults = []
    for kind, ratios in (("forward", fwd_ratios), ("backward", bwd_ratios)):
        if len(ratios) != 6 or not all(x <= FUSION_CALL_RATIO for x in ratios):
            faults.append(f"the 40 x {K} {kind} calls' errors over the bf16 rule's bound "
                          f"{[round(x, 3) for x in ratios]}, expected 6 at most "
                          f"{FUSION_CALL_RATIO}")
    for k, ref in losses["cpu"].items():
        if not abs(losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            faults.append(f"{k}: card {losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    return r, faults


def load_params(path: str) -> dict:
    """The parameters of a saved train state, memory-mapped: AdamW's ``mu``
    and ``nu`` (two thirds of the file) are never read."""
    state = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    return {k: v.clone() for k, v in state["params"].items()}


def kept_params_save(kept: dict, saves: list):
    """A stand-in for ``ckpt_lib.save_train_state`` for the launcher runs
    whose saved state no later phase and no resume reads (phases 18-23): it
    keeps the model's parameters, as ``load_params`` would read them back,
    in ``kept["params"]`` and writes nothing (a large model's train state
    with AdamW's moments is ~11 GB, ~13 s a save); ``saves`` gets each
    call's seconds."""
    def save(ckpt_dir, model, optimizer, step, data_state=None):
        t = time.perf_counter()
        kept.update(params={n: p.detach().cpu() for n, p in model.named_parameters()},
                    step=step, dir=ckpt_dir)
        saves.append(time.perf_counter() - t)
        return None

    return save


def work_dir(root: str, need_bytes: int) -> str:
    """A directory in RAM (``/dev/shm``) with room for ``need_bytes``, else
    ``root``: the card's machine caps what one call writes to its disk at
    45 GiB, and phases 8-11 write most of that (a train state of X2VLM-base
    is ~3.4 GB), so phase 7's, 12's and 13's train states (and phase 13's
    data) go to RAM."""
    shm = "/dev/shm"
    free = shutil.disk_usage(shm).free if os.path.isdir(shm) else 0
    log(f"{shm}: {free / 2**30:.1f} GiB free")
    if free >= need_bytes:
        return tempfile.mkdtemp(prefix="chip_smoke_", dir=shm)
    return root


def tower_task_phase(args, tower: str, root: str, tok_dir: str, image_root: str,
                     test_file: str, requests, dev, smi: str = ""):
    """One tower of phase 12: ``x2vlm_tpu_torch.run --task retrieval`` on
    the shipped config at its own sizes (steps of 32, eval calls of 64
    images, k_test 128) from weights drawn from ``--seed`` (no published
    file is in the repository), ``N_TOWER_STEPS`` steps and the two-stage
    eval, each call timed and its launches read; ``--resume`` restoring the
    saved state bit for bit; the 2-row hold; the trained state exported
    with ``python -m x2vlm_tpu_torch.export_serving`` and served by
    ``RetrievalServer.from_npz`` with the tower from the bundle's manifest:
    its features equal to the trained model's, the requests at B=128 timed
    and their launches read. A generator: it yields once the export has
    started and the hold is done, and on its next step serves the bundle
    and returns (``StopIteration.value``) the launches: the run's (split
    into steps and eval) and the requests'."""
    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.tasks import retrieval as retrieval_mod

    t0 = time.perf_counter()
    shipped = shipped_config(TOWER_CONFIGS[tower])
    with open(test_file) as f:
        test_ann = json.load(f)
    train_ann = [{"image": a["image"], "image_id": a["image_id"], "caption": c}
                 for a in test_ann[:N_TOWER_STEPS * TRAIN_BATCH // 2] for c in a["caption"][:2]]
    train_file = os.path.join(root, f"{tower}_train.json")
    with open(train_file, "w") as f:
        json.dump(train_ann, f)
    cfg = dict(shipped, train_file=[train_file], test_file=[test_file], image_root=image_root,
               text_encoder=tok_dir,
               vision_config=os.path.join(REPO_ROOT, shipped["vision_config"]))
    if (cfg["batch_size"], cfg["batch_size_test"], cfg["k_test"], cfg["image_res"]) != \
            (TRAIN_BATCH, TOWER_EVAL_BATCH, K_TEST, 224):
        fail(f"{tower} launcher: the shipped config's sizes {cfg['batch_size']}, "
             f"{cfg['batch_size_test']}, {cfg['k_test']}, {cfg['image_res']} changed")
    cfg_path = os.path.join(root, f"{tower}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    mcfg = xvlm_config_from_yaml(cfg)
    part_done(f"12 {tower}", "data", t0)
    work = work_dir(root, 8 * 2**30)   # a train state (~3.5 GB) and a bundle (~1.2 GB)
    out = os.path.join(work, f"out_{tower}")

    steps, evals = [], []
    orig = {"step": run_mod.make_train_step, "eval": retrieval_mod.evaluate_retrieval,
            "save": ckpt_lib.save_train_state}
    timed = functools.partial(timed_call, args, smi)

    def make_step(model, optimizer, **kw):
        return timed(orig["step"](model, optimizer, **kw), steps,
                     f"chip_smoke_{tower}_step_profile.txt",
                     lambda i: args.profile and i == N_TOWER_STEPS - 1)

    def save(ckpt_dir, model, optimizer, step, data_state=None):
        # the best epoch's copy is a hard link: a train state is ~3.4 GB
        if not ckpt_dir.endswith("ckpt_best"):
            return orig["save"](ckpt_dir, model, optimizer, step, data_state)
        os.makedirs(ckpt_dir, exist_ok=True)
        dst = os.path.join(ckpt_dir, ckpt_lib.TRAIN_STATE_FILE)
        if os.path.exists(dst):
            os.remove(dst)
        os.link(os.path.join(os.path.dirname(ckpt_dir), "ckpt", ckpt_lib.TRAIN_STATE_FILE), dst)
        return dst

    argv = ["--task", "retrieval", "--config", cfg_path, "--output_dir", out, "--epoch", "1",
            "--seed", str(args.seed), "--device", dev.type]
    t1 = time.perf_counter()
    reset_counts()
    run_mod.make_train_step, ckpt_lib.save_train_state = make_step, save
    retrieval_mod.evaluate_retrieval = timed(orig["eval"], evals,
                                             f"chip_smoke_{tower}_eval_profile.txt",
                                             lambda i: bool(args.profile))
    try:
        record = run_mod.main(argv)
    finally:
        run_mod.make_train_step, ckpt_lib.save_train_state = orig["step"], orig["save"]
        retrieval_mod.evaluate_retrieval = orig["eval"]
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"phase 12 {tower} run ({len(steps)} fine-tune steps + eval): "
        f"{part_done(f'12 {tower}', 'run', t1):.1f} s; {json.dumps(record)}")
    log(f"phase 12 {tower} fine-tune step ms at 224 px, B={TRAIN_BATCH} (CUDA events, wall): "
        f"{json.dumps([[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in steps])}"
        f"{' (the last one profiled)' if args.profile else ''}; peak device memory GiB "
        f"{[round(r['peak_gib'], 2) for r in steps]}; eval (64 images, 320 texts, k_test "
        f"{K_TEST}) ms (CUDA events, wall) "
        f"{[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in evals]}, peak GiB "
        f"{[round(r['peak_gib'], 2) for r in evals]}"
        f"{' (profiled)' if args.profile else ''}; {smi}")
    keys = ("txt_r1", "txt_r5", "txt_r10", "img_r1", "img_r5", "img_r10", "r_mean")
    vals = [record.get(f"eval_{k}") for k in keys] + [record.get("loss_itc"),
                                                       record.get("loss_itm")]
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals) or \
            len(steps) != N_TOWER_STEPS or len(evals) != 1:
        fail(f"{tower} launcher: {len(steps)} steps, {len(evals)} evals, record {record}")
    for kind, records in (("step", steps), ("eval", evals)):
        want = tower_call_launches(tower, kind)
        for i, r in enumerate(records):
            got = dict(r["launches"], plain=r["plain"])
            if got != want:
                fail(f"{tower} launcher {kind} {i}: launches {got}, expected {want}")
            d = r["delta"]
            if sum(d["flash_fwd_nobias"].values()) != d["flash_fwd"] or \
                    sum(d["flash_bwd_nobias"].values()) != sum(d["flash_bwd"].values()):
                fail(f"{tower} launcher {kind} {i}: flash launches with a bias: {d}")
    tiny = collections.Counter()
    for kind, n in (("step", N_TOWER_STEPS), ("eval", 1)):
        for shape, m in tower_call_launches(tower, kind)["tiny_fwd"].items():
            tiny[shape] += n * m
    per_call = tower_call_launches(tower, "step")
    check_launcher_counts(
        f"{tower} launcher", counts, (12 * (N_TOWER_STEPS + 1)) if tower == "clip" else 0,
        per_call["flash_bwd"] * N_TOWER_STEPS,
        {"tiny_fwd": dict(tiny),
         "tiny_bwd": {k: n * N_TOWER_STEPS for k, n in per_call["tiny_bwd"].items()}},
        n_plain=(N_TOWER_STEPS + 1) * tower_call_launches(tower, "eval")["plain"],
        bwd_kernels=("dq", "dkv"))

    # --resume: the restored state is the saved one (nothing left to train)
    saved = torch.load(os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE), map_location="cpu",
                       weights_only=False)
    restored = {}
    orig_restore = ckpt_lib.restore_train_state

    def restore(ckpt_dir, model, optimizer):
        result = orig_restore(ckpt_dir, model, optimizer)
        restored.update(params={n: p.detach().cpu() for n, p in model.named_parameters()},
                        mu=dict(zip(optimizer.names, (m.cpu() for m in optimizer.mu))),
                        nu=dict(zip(optimizer.names, (v.cpu() for v in optimizer.nu))),
                        count=optimizer.count)
        return result

    t2 = time.perf_counter()
    ckpt_lib.restore_train_state = restore
    try:
        run_mod.main(argv + ["--resume"])
    finally:
        ckpt_lib.restore_train_state = orig_restore
    same = bool(restored) and restored["count"] == saved["count"] and all(
        restored[part].keys() == saved[part].keys() and
        all(torch.equal(restored[part][k], saved[part][k]) for k in saved[part])
        for part in ("params", "mu", "nu"))
    log(f"phase 12 {tower} --resume: restored state equal to the saved one bit for bit: "
        f"{same} (step {saved['step']}, count {saved['count']}); "
        f"{part_done(f'12 {tower}', 'resume', t2):.1f} s")
    if not same:
        fail(f"{tower} launcher --resume: the restored state differs from the saved one")
    state = saved["params"]
    del saved, restored

    # the export CLI, on the host beside the hold and the other tower's run
    bundle = os.path.join(work, f"bundle_{tower}")
    t_export = time.perf_counter()
    export = subprocess.Popen(
        [sys.executable, "-m", "x2vlm_tpu_torch.export_serving", "--task", "retrieval",
         "--config", cfg_path, "--checkpoint", os.path.join(out, "ckpt"), "--out", bundle,
         "--device", "cpu"], cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    # the trained weights on 2 rows, card bf16 against CPU fp32
    _, test_ds = create_dataset("retrieval", cfg, evaluate=True)
    ids, atts = (torch.from_numpy(a) for a in test_ds.text_batch([0, 5]))
    batch = {"image": torch.from_numpy(test_ds.image_batch([0, 1])), "text_ids": ids.long(),
             "text_atts": atts, "idx": torch.tensor([0, 1])}
    t_hold = time.perf_counter()
    hold, faults = tower_hold(tower, state, mcfg, batch, dev)
    part_done(f"12 {tower}", "hold", t_hold)
    log(f"phase 12 {tower} card bf16 vs CPU fp32 (2 rows, dropout and drop path off): "
        f"{json.dumps(hold)}")
    for msg in faults:
        fail(f"{tower} launcher, 2 rows card vs CPU: {msg}")
    t_other = time.perf_counter()
    yield   # the caller runs the other tower up to here
    part_done(f"12 {tower}", "other tower", t_other)

    # the bundle served with the tower from its manifest
    t3 = time.perf_counter()
    stdout, stderr = export.communicate(timeout=900)
    shutil.rmtree(out)
    log(f"phase 12 {tower} export: exit {export.returncode}, "
        f"{time.perf_counter() - t_export:.1f} s of its own, "
        f"{part_done(f'12 {tower}', 'export', t3):.1f} s waited; {stdout.strip()[-300:]}")
    if export.returncode:
        fail(f"{tower} export_serving: exit {export.returncode}: {stderr[-2000:]}")
        if work != root:
            shutil.rmtree(work)
        return {"run": split_counts(counts, [r["delta"] for r in steps]), "requests": {}}
    t_serve = time.perf_counter()
    server = RetrievalServer.from_npz(os.path.join(bundle, "params.npz"), device=dev)
    model = XVLMForRetrieval(mcfg, dtype=torch.bfloat16, device=dev, seed=None)
    model.load_state_dict(state)
    del state
    served_tower = type(server.model.vision_encoder).__name__
    with torch.inference_mode():
        pairs = ((server.encode_images(batch["image"])[1],
                  model.encode_images(batch["image"].to(dev))[1]),
                 (server.encode_texts(ids, atts)[1],
                  model.encode_texts(ids.to(dev), atts.to(dev))[1]))
    same = all(torch.equal(a, b) for a, b in pairs)
    log(f"phase 12 {tower} bundle: tower {served_tower} from the manifest, served features "
        f"equal to the trained model's: {same} (largest difference "
        f"{max(max_err(a, b) for a, b in pairs):.3e})")
    if not same or server.model.config != mcfg:
        fail(f"{tower} bundle: the served model differs from the trained one "
             f"({served_tower})")
    del model, pairs
    shutil.rmtree(bundle)
    if work != root:
        shutil.rmtree(work)
    part_done(f"12 {tower}", "bundle load and check", t_serve)

    # the requests at B=128 through the served bundle
    t_req = time.perf_counter()
    req_counts = {k: collections.Counter() for k in LEDGER_PARTS}
    outs = []
    images, r_ids, r_atts = requests
    for name, fn, inputs in (("encode_images", server.encode_images, lambda: (images,)),
                             ("encode_texts", server.encode_texts, lambda: (r_ids, r_atts)),
                             ("itm_score", server.itm_score,
                              lambda: (outs[0][0], outs[1][0], r_atts))):
        reset_counts()
        outs.append(fn(*inputs()))
        torch.cuda.synchronize()
        c = launch_counts()
        got = {"flash_fwd": c["flash_fwd"], "flash_bwd": 0, "tiny_fwd": dict(c["tiny_fwd"]),
               "tiny_bwd": {}, "plain": c["plain_attention"]}
        if got != tower_call_launches(tower, name) or \
                sum(c["flash_fwd_nobias"].values()) != c["flash_fwd"] or \
                c["flash_fwd_routes"] != ({TENSOR_CORE: c["flash_fwd"]} if c["flash_fwd"]
                                          else {}):
            fail(f"{tower} request {name}: launches {got}, expected "
                 f"{tower_call_launches(tower, name)}")
        if c["tiny_fwd"]:
            check_tiny_routes(f"{tower} request {name}",
                              {"tiny_attention_fwd": c["tiny_routes"]["tiny_attention_fwd"]})
        for k in LEDGER_PARTS:
            req_counts[k].update(c[k])
    if not all(torch.isfinite(o if torch.is_tensor(o) else o[1]).all() for o in outs):
        fail(f"{tower} requests: outputs not finite")
    req_ms = time_requests(server, requests, (outs[0][0], outs[0][1], outs[1][0]))
    log(f"phase 12 {tower} request ms (B={BATCH}, CUDA events, median of 5): "
        f"{json.dumps({k: round(v, 3) for k, v in req_ms.items()})}; {smi}")
    del server, outs
    torch.cuda.empty_cache()
    part_done(f"12 {tower}", "requests", t_req)
    phase_seconds(f"12 {tower}", t0)
    return {"run": split_counts(counts, [r["delta"] for r in steps]), "requests": req_counts}


def tower_launcher_phase(args, root, tok_dir, image_root, test_file, requests, dev, smi=""):
    """Phase 12: CLIP ViT-B/16, then Swin-B/224, each up to its export
    (``tower_task_phase`` yields there: the export CLI runs on the host
    beside the next tower's run), then each tower's served bundle. Returns
    each tower's launches."""
    towers = {tower: tower_task_phase(args, tower, root, tok_dir, image_root, test_file,
                                      requests, dev, smi) for tower in ("clip", "swin")}
    for phase in towers.values():
        next(phase)
        torch.cuda.empty_cache()
    out = {}
    for tower, phase in towers.items():
        try:
            next(phase)
        except StopIteration as done:
            out[tower] = done.value
        torch.cuda.empty_cache()
    return out


# ---- phase 13: the video path (stage-2 video-text pretraining, video QA) ----

STAGE2_CONFIG = "configs/pretrain/x2vlm_base_1b_stage2_video.yaml"
VIDEO_QA_CONFIG = "configs/finetune/vqa_msrvtt_base.yaml"
N_VIDEO_LINES, N_VIDEO_FRAMES = 64, 8  # 13a: video lines, frames a video (PNG, 224 px)
VIDEO_STEPS, VIDEO_RESUME_STEPS = 2, 3  # 13a: 2 steps, then --resume to step 3
N_QA_ANSWERS = 1500                  # 13b: the answer list
QA_EPOCHS = 2                        # 13b: 2 steps an epoch, a save after step 2
N_QA_TRAIN = 2 * QA_VIDEOS           # train questions: 2 steps an epoch
N_QA_EVAL = 2 * QA_EVAL_VIDEOS       # test videos: 2 eval calls
N_QA_STEPS = QA_EPOCHS * N_QA_TRAIN // QA_VIDEOS
QA_RESUME_STEP = N_QA_TRAIN // QA_VIDEOS
VISION_WIDTH = 768                   # BEiT-2-base: the frame positions' width


def write_video_corpus(path: str, rng: np.random.Generator, words, frames_key: str = "frames",
                       caption_key: str = "caption") -> None:
    """``N_VIDEO_LINES`` stage-2 video lines (reference FrameTextDataset):
    under ``frames_key`` a list of ``N_VIDEO_FRAMES`` base64 PNGs of 224 px
    and under ``caption_key`` a caption (a list of two for some); every
    fourth line a clip-of-clips (clips of 2 to 3 frames, a caption each, one
    of them "[Music]", which the stream never picks)."""
    frame = lambda: base64.b64encode(random_png(rng, 224)).decode()
    with open(path, "w") as f:
        for i in range(N_VIDEO_LINES):
            if i % 4 == 3:
                clips = [[frame() for _ in range(n)] for n in (3, 3, 2)]
                caps = [caption(rng, words, 4, 12) for _ in clips]
                caps[int(rng.integers(0, 3))] = "[Music]"
                line = {frames_key: clips, caption_key: caps}
            else:
                cap = caption(rng, words)
                line = {frames_key: [frame() for _ in range(N_VIDEO_FRAMES)],
                        caption_key: [cap, caption(rng, words)] if i % 3 == 0 else cap}
            f.write(json.dumps(line) + "\n")


def video_stream_launches() -> dict:
    """The tiny launches of one video-stream step (forward and backward
    alike): the text pass over the 40 clean and 40 masked rows, the ITM +
    MLM fusion pass over 4 x 40 rows, its self- and cross-attentions."""
    V = STREAM_VIDEOS
    return {(2 * V, TEXT_LEN, TEXT_LEN): 12, (4 * V, TEXT_LEN, TEXT_LEN): 6,
            (4 * V, TEXT_LEN, 200): 6}


def video_pretrain_phase(args, root: str, th_path: str, tok_dir: str, words, work: str, dev,
                         smi: str = ""):
    """13a: ``x2vlm_tpu_torch.run --task pretrain`` on the shipped stage-2
    video config from phase 7's ``.th`` (its frame positions fresh): the
    image stream as shipped (128 a step) on phase 7's lines, the region block as
    shipped on phase 7's region lines, the video block as shipped (40
    videos x 3 frames) on ``N_VIDEO_LINES`` lines written here; 2 steps,
    then ``--resume`` to step 3, whose restored state and data cursors (the
    video cursor among them) must equal the saved ones bit for bit. Each
    stream's calls timed and the video stream's launches read per call.
    Returns the path of the final weights exported as a reference-named
    ``.th``, those weights, the run's ``XVLMConfig`` and the launches of the
    first run."""
    from x2vlm_tpu_torch import run as run_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 13)
    video_file = os.path.join(work, "videos.jsonl")
    write_video_corpus(video_file, rng, words)
    shipped = shipped_config(STAGE2_CONFIG)
    cfg = dict(shipped, train_file=[os.path.join(root, "images.jsonl")],
               train_file_regions=[os.path.join(root, "regions.jsonl")],
               train_file_videos=[video_file], text_encoder=tok_dir,
               train_dataset_size=PRETRAIN_BATCH,       # 1 step an epoch
               ckpt_frequent=1000, ckpt_frequent_step=1000)   # a save after the last step
    sizes = (cfg["images"]["batch_size"], cfg["videos"]["batch_size"], cfg["frame_len"],
             cfg["regions"]["batch_size"], cfg["regions"]["max_images"],
             cfg["video_encoding"], cfg["add_frame_pos"])
    if sizes != (PRETRAIN_BATCH, STREAM_VIDEOS, STREAM_FRAMES, REGION_ROWS, REGION_IMAGES,
                 "avgpool", True):
        fail(f"video pretrain launcher: the shipped config's sizes {sizes} changed")
    cfg_path = os.path.join(work, "stage2.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(work, "out_video_pretrain")
    argv = ["--task", "pretrain", "--config", cfg_path, "--output_dir", out, "--checkpoint",
            th_path, "--seed", str(args.seed), "--device", dev.type]
    log(f"phase 13a data and config: {part_done('13a', 'data', t0):.1f} s")

    imported = {}
    orig_load = ckpt_lib.load_reference_checkpoint

    def load(model, path):
        imported["missing"], imported["unexpected"] = orig_load(model, path)
        return imported["missing"], imported["unexpected"]

    t1 = time.perf_counter()
    reset_counts()
    ckpt_lib.load_reference_checkpoint = load
    try:
        with StreamTimer(("video", VIDEO_STEPS - 1) if args.profile else None,
                         (args, smi, "chip_smoke_video_pretrain_profile.txt")) as timer:
            record = run_mod.main(argv + ["--epoch", str(VIDEO_STEPS)])
            check_data_plane("phase 13a", record)
    finally:
        ckpt_lib.load_reference_checkpoint = orig_load
    torch.cuda.synchronize()
    counts1 = launch_counts()
    log(f"phase 13a run 1 ({VIDEO_STEPS} steps): {part_done('13a', 'run', t1):.1f} s; "
        f"{json.dumps(record)}")
    if imported.get("missing") != ["absolute_frame_pos_embed"]:
        fail(f"video pretrain launcher import of {th_path}: missing {imported.get('missing')},"
             f" expected only the fresh frame positions")
    losses = [f"{s}_loss_{k}" for s in ("image", "video") for k in ("itc", "itm", "mlm")] + \
        ["region_loss_bbox", "region_loss_giou"]
    if not all(isinstance(record.get(k), float) and math.isfinite(record[k]) for k in losses) \
            or record.get("broken", -1) != 0:
        fail(f"video pretrain launcher: losses {[record.get(k) for k in losses]}, broken "
             f"{record.get('broken')}")
    n = VIDEO_STEPS
    want_tiny = collections.Counter({(2 * PRETRAIN_BATCH, TEXT_LEN, TEXT_LEN): 12 * n,
                                     (4 * PRETRAIN_BATCH, TEXT_LEN, TEXT_LEN): 6 * n,
                                     (4 * PRETRAIN_BATCH, TEXT_LEN, 200): 6 * n})
    for part in (region_step_launches(6), video_stream_launches()):
        want_tiny.update({k: v * n for k, v in part.items()})
    check_launcher_counts("video pretrain launcher", counts1, 36 * n, 36 * n,
                          {"tiny_fwd": dict(want_tiny), "tiny_bwd": dict(want_tiny)})
    frames = STREAM_VIDEOS * STREAM_FRAMES
    video_calls = timer.calls["video"]
    if len(video_calls) != n:
        fail(f"video pretrain launcher: {len(video_calls)} video-stream calls, expected {n}")
    for i, c in enumerate(video_calls):
        tag = f"video pretrain launcher video step {i}"
        check_launcher_counts(tag, c["launches"], 12, 12, {"tiny_fwd": video_stream_launches(),
                                                           "tiny_bwd": video_stream_launches()})
        if dict(c["launches"]["flash_fwd_shapes"]) != {(frames, N_IMG, N_IMG): 12}:
            fail(f"{tag}: flash shapes {dict(c['launches']['flash_fwd_shapes'])}, expected 12 "
                 f"at {frames} frames")
    log(f"phase 13a by stream (CUDA-event ms and wall ms of each call, median; peak GiB; "
        f"{smi}): {json.dumps(timer.summary())}")
    video_ms = [[round(c["ms"], 3), round(c["wall_ms"], 3), round(c["peak_gib"], 2)]
                for c in video_calls]

    # --resume to step 3: the saved state and data cursors restored bit for bit
    state_path = os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE)
    saved = torch.load(state_path, map_location="cpu", weights_only=False)
    seen = {}
    orig = run_mod.maybe_resume

    def resumed(a, model, optimizer):
        step, data_state = orig(a, model, optimizer)
        params = dict(model.named_parameters())
        seen.update(
            step=step, data_state=data_state,
            params=all(torch.equal(params[k].detach().cpu(), v)
                       for k, v in saved["params"].items()),
            mu=all(torch.equal(m.cpu(), saved["mu"][k])
                   for k, m in zip(optimizer.names, optimizer.mu)),
            nu=all(torch.equal(v.cpu(), saved["nu"][k])
                   for k, v in zip(optimizer.names, optimizer.nu)),
            count=optimizer.count == saved["count"])
        return step, data_state

    t2 = time.perf_counter()
    run_mod.maybe_resume = resumed
    try:
        with StreamTimer() as timer2:
            record2 = run_mod.main(argv + ["--resume", "--epoch", str(VIDEO_RESUME_STEPS)])
    finally:
        run_mod.maybe_resume = orig
    torch.cuda.synchronize()
    video_ms += [[round(c["ms"], 3), round(c["wall_ms"], 3), round(c["peak_gib"], 2)]
                 for c in timer2.calls["video"]]
    log(f"phase 13a video-stream calls ({STREAM_VIDEOS} videos x {STREAM_FRAMES} frames; CUDA "
        f"events ms, wall ms, peak GiB; steps 1-{VIDEO_RESUME_STEPS}"
        f"{', step 2 profiled' if args.profile else ''}): {json.dumps(video_ms)}; {smi}")
    log(f"phase 13a run 2 (--resume to step {VIDEO_RESUME_STEPS}): "
        f"{part_done('13a', 'resume', t2):.1f} s; resumed at step {seen.get('step')}, data cursors "
        f"{seen.get('data_state')}; equal to the saved state: params {seen.get('params')}, "
        f"mu {seen.get('mu')}, nu {seen.get('nu')}, count {seen.get('count')}; "
        f"{json.dumps(record2)}")
    if not (seen.get("step") == VIDEO_STEPS and seen.get("params") and seen.get("mu")
            and seen.get("nu") and seen.get("count")
            and seen.get("data_state") == saved["data_state"]
            and set(saved["data_state"]) == {"image", "region", "video"}):
        fail(f"video pretrain launcher --resume: {seen} against the saved step "
             f"{saved['step']}")
    if record2.get("pretrain_steps") != [VIDEO_STEPS, VIDEO_RESUME_STEPS] or \
            record2.get("broken", -1) != 0:
        fail(f"video pretrain launcher --resume: {record2}")
    del saved

    final = load_params(state_path)
    th13 = os.path.join(work, "x2vlm_phase13.th")
    torch.save({"model": {k[len("base."):]: v for k, v in final.items()}}, th13)
    fp = final.get("base.absolute_frame_pos_embed")
    log(f"phase 13a exported {th13}: absolute_frame_pos_embed "
        f"{None if fp is None else list(fp.shape)}")
    if fp is None or tuple(fp.shape) != (1, STREAM_FRAMES, 1, VISION_WIDTH):
        fail("video pretrain launcher: the exported .th lacks the (1, 3, 1, 768) frame "
             "positions")
    shutil.rmtree(out, ignore_errors=True)
    phase_seconds("13a", t0)
    return th13, final, xvlm_config_from_yaml(cfg), counts1


def video_pretrain_hold(final, cfg, dev) -> tuple:
    """The stage-2 weights ``final`` (or the train state saved at that path)
    on 2 videos of 3 uint8 frames, dropout off, the
    ITM negatives injected: the card in bf16 against the port's CPU fp32
    path: ITC, ITM and MLM within 0.05 + 2%, gradient cosines >= 0.99 (the
    vision tower, the frame positions, a fusion layer, the ITM head), each
    bf16 40 x 200 call of the ITM + MLM fusion pass held on the model's
    operands to the plain version (``FUSION_CALL_RATIO``). ``cfg`` is the
    run's ``XVLMConfig``."""
    final = params_of(final)
    res = cfg.vision.image_res
    gen = torch.Generator().manual_seed(13)
    batch = {"image": torch.randint(0, 256, (2, STREAM_FRAMES, res, res, 3), generator=gen,
                                    dtype=torch.uint8),
             "text_ids": torch.randint(1000, 30000, (2, TEXT_LEN), generator=gen),
             "text_atts": torch.ones(2, TEXT_LEN, dtype=torch.int32),
             "masked_pos": torch.tensor([[3, 7, 9], [2, 5, 20]]),
             "masked_ids": torch.randint(1000, 30000, (2, 3), generator=gen)}
    batch["text_atts"][1, 25:] = 0
    batch["text_ids"][:, 0] = 101
    batch["text_ids"] = batch["text_ids"] * batch["text_atts"]
    masked = batch["text_ids"].clone()
    masked[torch.arange(2)[:, None], batch["masked_pos"]] = 103
    batch["text_ids_masked"] = masked
    neg = (torch.tensor([1, 0]), torch.tensor([1, 0]))
    f = f"base.text_encoder.bert.encoder.layer.{cfg.text.fusion_layer}"
    names = ("base.vision_encoder.blocks.0.attn.qkv.weight",
             "base.vision_encoder.blocks.0.attn.relative_position_bias_table",
             "base.absolute_frame_pos_embed", f"{f}.attention.self.query.weight",
             f"{f}.crossattention.self.key.weight", "base.itm_head.0.weight")
    fwd_ratios, bwd_ratios, losses, grads = [], [], {}, {}
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        model = XVLMForPretrain(cfg, dtype=dtype, device=device, seed=None)
        model.load_state_dict(final)
        b = {k: v.to(device) for k, v in batch.items()}
        with held_tiny_calls(200, fwd_ratios), held_tiny_bwd_calls(200, bwd_ratios):
            out = model(b, neg_idx=tuple(t.to(device) for t in neg))
            sum(out.values()).backward()
        losses[tag] = {k: v.item() for k, v in out.items()}
        params = dict(model.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1) for k in names}
        del model, out, b
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in names}
    r = {"losses": losses, "cosine": cos, "fwd_ratios": fwd_ratios, "bwd_ratios": bwd_ratios}
    faults = []
    for kind, ratios in (("forward", fwd_ratios), ("backward", bwd_ratios)):
        if len(ratios) != 6 or not all(x <= FUSION_CALL_RATIO for x in ratios):
            faults.append(f"the 40 x 200 {kind} calls' errors over the bf16 rule's bound "
                          f"{[round(x, 3) for x in ratios]}, expected 6 at most "
                          f"{FUSION_CALL_RATIO}")
    for k, ref in losses["cpu"].items():
        if not abs(losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            faults.append(f"{k}: card {losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    return r, faults


def write_video_qa_corpus(root: str, rng: np.random.Generator, words):
    """``N_QA_EVAL`` videos as directories of ``N_VIDEO_FRAMES`` PNG frames
    (224 px) under ``root/videos``, an answer list of ``N_QA_ANSWERS``
    distinct answers, ``N_QA_TRAIN`` train and ``N_QA_EVAL`` test
    questions (MSRVTT-QA lines {video, question, answer}, an answer off the
    list now and then). Returns (video root, train, test, answer list)."""
    video_root = os.path.join(root, "videos")
    for v in range(N_QA_EVAL):
        d = os.path.join(video_root, f"video{v}")
        os.makedirs(d)
        for j in range(N_VIDEO_FRAMES):
            with open(os.path.join(d, f"{j:05d}.png"), "wb") as f:
                f.write(random_png(rng, 224))
    answers, seen = [], set()
    while len(answers) < N_QA_ANSWERS:
        a = caption(rng, words, 1, 3)
        if a not in seen:
            seen.add(a)
            answers.append(a)

    def line(v):
        answer = answers[int(rng.integers(0, N_QA_ANSWERS))] if rng.random() < 0.9 \
            else "an answer off the list"
        return {"video": f"video{v}", "question": caption(rng, words, 4, 14), "answer": answer}

    paths = [os.path.join(root, f"video_qa_{n}.json") for n in ("train", "test", "answers")]
    for path, data in zip(paths, ([line(v) for v in range(N_QA_TRAIN)],
                                  [line(v) for v in range(N_QA_EVAL)], answers)):
        with open(path, "w") as f:
            json.dump(data, f)
    return (video_root, *paths)


def video_qa_launches(train: bool) -> dict:
    """The attention launches of one video QA step (8 videos) or eval call
    (16 videos): 12 flash over the 5-frame batch; tiny at 40 x 40 (the 12
    text layers and the 6 fusion self-attentions) and 40 x 200 (the 6
    fusion cross-attentions); the backward the same; no plain attention."""
    B = QA_VIDEOS if train else QA_EVAL_VIDEOS
    tiny = {(B, TEXT_LEN, TEXT_LEN): 18, (B, TEXT_LEN, 200): 6}
    return {"flash_fwd": 12, "flash_bwd": 12 if train else 0, "tiny_fwd": tiny,
            "tiny_bwd": tiny if train else {}}


def video_qa_hold(state, mcfg, samples, dev) -> tuple:
    """The fine-tuned video QA weights ``state`` (or the train state saved
    at that path) on 2 videos, dropout off, the card in
    bf16 against the port's CPU fp32 path: ``loss_cls`` within 0.05 + 2%,
    the logits within 0.05 + 5% of their scale, gradient cosines >= 0.99
    (the vision tower, the frame positions, a fusion layer, ``cls_head``),
    each bf16 40 x 200 forward and backward call held on the model's
    operands (``FUSION_CALL_RATIO``)."""
    state = params_of(state)
    from x2vlm_tpu_torch.models import XVLMForClassification

    n_labels = state["cls_head.3.weight"].shape[0]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}
    batch["labels"] = batch["labels"].long()
    f = f"text_encoder.bert.encoder.layer.{mcfg.text.fusion_layer}"
    names = ("vision_encoder.blocks.0.attn.qkv.weight",
             "vision_encoder.blocks.0.attn.relative_position_bias_table",
             "absolute_frame_pos_embed", f"{f}.attention.self.query.weight",
             f"{f}.crossattention.self.key.weight", "cls_head.0.weight", "cls_head.3.weight")
    fwd_ratios, bwd_ratios, outs, losses, grads = [], [], {}, {}, {}
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        model = XVLMForClassification(mcfg, dtype=dtype, device=device, seed=None,
                                      num_labels=n_labels)
        model.load_state_dict(state)
        b = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            outs[tag] = model.predict(b).float().cpu()
        with held_tiny_calls(200, fwd_ratios), held_tiny_bwd_calls(200, bwd_ratios):
            out = model(b)
            out["loss_cls"].backward()
        losses[tag] = out["loss_cls"].item()
        params = dict(model.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1) for k in names}
        del model, out, b
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in names}
    out_err, scale = max_err(outs["card"], outs["cpu"]), outs["cpu"].abs().max().item()
    r = {"loss_cls": losses, "logit_err": out_err, "logit_scale": scale, "cosine": cos,
         "fwd_ratios": fwd_ratios, "bwd_ratios": bwd_ratios}
    faults = []
    for kind, ratios in (("forward", fwd_ratios), ("backward", bwd_ratios)):
        if len(ratios) != 6 or not all(x <= FUSION_CALL_RATIO for x in ratios):
            faults.append(f"the 40 x 200 {kind} calls' errors over the bf16 rule's bound "
                          f"{[round(x, 3) for x in ratios]}, expected 6 at most "
                          f"{FUSION_CALL_RATIO}")
    if not out_err <= 0.05 + 0.05 * scale:
        faults.append(f"logits off the CPU fp32 path's by {out_err:.4f} (scale {scale:.4f})")
    if not abs(losses["card"] - losses["cpu"]) <= 0.05 + 0.02 * abs(losses["cpu"]):
        faults.append(f"loss_cls: card {losses['card']:.5f} vs CPU fp32 {losses['cpu']:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    return r, faults


def video_qa_phase(args, root: str, th13: str, tok_dir: str, words, work: str, dev,
                   smi: str = "") -> dict:
    """13b: ``x2vlm_tpu_torch.run --task video_qa`` on the shipped
    ``vqa_msrvtt_base.yaml`` at its own sizes (8 videos x 5 frames a step,
    16 videos an eval call), data written under ``root``, from 13a's
    ``.th`` (its 3 frame positions into 5: the first three loaded, two
    fresh), 2 epochs of 2 steps and the eval of 32 videos after the last:
    each step and eval call timed and its launches read; ``--resume`` from
    the state saved at step 2, its restored state and the batches after it
    equal to the whole run's bit for bit; then ``video_qa_hold`` on 2
    videos. Returns the launches split by operands."""
    import hashlib

    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.models import XVLMForClassification
    from x2vlm_tpu_torch.tasks import classification as cls_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 14)
    video_root, train, test, answers = write_video_qa_corpus(work, rng, words)
    cfg = dict(shipped_config(VIDEO_QA_CONFIG), video_root=video_root, text_encoder=tok_dir,
               train_file=[train], test_file=[test], answer_list=answers,
               start_eval=QA_EPOCHS - 1)
    sizes = (cfg["batch_size"], cfg["batch_size_test"], cfg["frame_len"], cfg["image_res"],
             cfg["dataset_type"], cfg["add_frame_pos"])
    if sizes != (QA_VIDEOS, QA_EVAL_VIDEOS, QA_FRAMES, 224, "video_qa", True):
        fail(f"video qa launcher: the shipped config's sizes {sizes} changed")
    cfg_path = os.path.join(work, "video_qa.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out, out_resumed = os.path.join(work, "out_video_qa"), os.path.join(work, "out_qa_resumed")
    log(f"phase 13b data and config: {part_done('13b', 'data', t0):.1f} s")

    imported, steps, evals, eval_walls = {}, [], [], []
    batches = {"whole": [], "resumed": []}
    run_name = ["whole"]
    orig = {"load": ckpt_lib.load_reference_checkpoint, "save": ckpt_lib.save_train_state,
            "step": run_mod.make_train_step, "to_device": run_mod.to_device,
            "predict": XVLMForClassification.predict,
            "evaluate": cls_mod.evaluate_classification}
    timed = functools.partial(timed_call, args, smi)
    th_frames = torch.load(th13, map_location="cpu", weights_only=False,
                           mmap=True)["model"]["absolute_frame_pos_embed"].clone()

    def load(model, path):
        fresh = model.absolute_frame_pos_embed.detach().cpu().clone()
        imported["missing"], imported["unexpected"] = orig["load"](model, path)
        got = model.absolute_frame_pos_embed.detach().cpu()
        imported["frames"] = [list(th_frames.shape), list(got.shape),
                              bool(torch.equal(got[:, :STREAM_FRAMES], th_frames)),
                              bool(torch.equal(got[:, STREAM_FRAMES:], fresh[:, STREAM_FRAMES:]))]
        return imported["missing"], imported["unexpected"]

    def save(ckpt_dir, model, optimizer, step, data_state=None):
        path = orig["save"](ckpt_dir, model, optimizer, step, data_state)
        if step == QA_RESUME_STEP and ckpt_dir == os.path.join(out, "ckpt"):
            orig["save"](os.path.join(out_resumed, "ckpt"), model, optimizer, step, data_state)
        return path

    def to_device(batch, device):
        batches[run_name[0]].append({k: hashlib.sha256(np.ascontiguousarray(v)).hexdigest()
                                     for k, v in batch.items()})
        return orig["to_device"](batch, device)

    def make_step(model, optimizer, **kw):
        return timed(orig["step"](model, optimizer, **kw), steps,
                     "chip_smoke_video_step_profile.txt",
                     lambda i: args.profile and i == N_QA_STEPS - 1)

    def evaluate(*a, **kw):
        t = time.perf_counter()
        result = orig["evaluate"](*a, **kw)
        eval_walls.append(time.perf_counter() - t)
        return result

    def patch(on: bool):
        ckpt_lib.load_reference_checkpoint = load if on else orig["load"]
        ckpt_lib.save_train_state = save if on else orig["save"]
        run_mod.make_train_step = make_step if on else orig["step"]
        run_mod.to_device = to_device if on else orig["to_device"]
        cls_mod.evaluate_classification = evaluate if on else orig["evaluate"]
        XVLMForClassification.predict = timed(
            orig["predict"], evals, "chip_smoke_video_eval_profile.txt",
            lambda i: bool(args.profile) and i == 0) if on else orig["predict"]

    argv = ["--task", "video_qa", "--config", cfg_path, "--checkpoint", th13, "--epoch",
            str(QA_EPOCHS), "--seed", str(args.seed), "--device", dev.type]
    t1 = time.perf_counter()
    reset_counts()
    patch(True)
    try:
        record = run_mod.main(argv + ["--output_dir", out])
    finally:
        patch(False)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"phase 13b run ({len(steps)} fine-tune steps + eval): "
        f"{part_done('13b', 'run', t1):.1f} s; {json.dumps(record)}")
    log(f"phase 13b video QA step ms at 224 px, {QA_VIDEOS} videos x {QA_FRAMES} frames "
        f"(CUDA events, wall): "
        f"{json.dumps([[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in steps])}"
        f"{' (the last one profiled)' if args.profile else ''}; peak device memory GiB "
        f"{[round(r['peak_gib'], 2) for r in steps]}; eval calls ({QA_EVAL_VIDEOS} videos) ms "
        f"(CUDA events, wall) {[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in evals]}"
        f"{' (the first profiled)' if args.profile else ''}, peak GiB "
        f"{[round(r['peak_gib'], 2) for r in evals]}; eval wall seconds "
        f"{[round(w, 3) for w in eval_walls]} ({N_QA_EVAL} videos); {smi}")

    # the import: all but the fresh cls_head from 13a's .th, its 3 frame
    # positions into the first 3 of 5; left over what the model does not carry
    missing, unexpected = imported.get("missing"), imported.get("unexpected", [])
    log(f"phase 13b import: missing {missing}, unexpected {len(unexpected)} "
        f"({sorted({'.'.join(k.split('.')[:2]) for k in unexpected})}); frame positions "
        f"(.th shape, model shape, first 3 loaded, last 2 fresh): {imported.get('frames')}")
    fresh = sorted(f"cls_head.{i}.{w}" for i in (0, 1, 3) for w in ("weight", "bias"))
    leftover = ("vision_proj.", "text_proj.", "itm_head.", "text_encoder.cls.", "bbox_head.")
    if missing != fresh or not unexpected or \
            not all(k.startswith(leftover) for k in unexpected) or \
            imported.get("frames") != [[1, STREAM_FRAMES, 1, VISION_WIDTH],
                                       [1, QA_FRAMES, 1, VISION_WIDTH], True, True]:
        fail(f"video qa launcher import of {th13}: missing {missing}, unexpected {unexpected}, "
             f"frames {imported.get('frames')}")
    with open(answers) as f:
        n_answers = len(json.load(f))
    vals = [record.get(k) for k in ("eval_accuracy", "loss_cls")]
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals) or \
            len(steps) != N_QA_STEPS or len(evals) != N_QA_EVAL // QA_EVAL_VIDEOS or \
            record.get("eval_n") != N_QA_EVAL or n_answers != N_QA_ANSWERS:
        fail(f"video qa launcher: {len(steps)} steps, {len(evals)} eval calls, record {record}")
    want_step, want_eval = video_qa_launches(True), video_qa_launches(False)
    for tag, records, want, frames in (("step", steps, want_step, QA_VIDEOS * QA_FRAMES),
                                       ("eval call", evals, want_eval,
                                        QA_EVAL_VIDEOS * QA_FRAMES)):
        for i, r in enumerate(records):
            if r["launches"] != want or r["plain"] or \
                    dict(r["delta"]["flash_fwd_shapes"]) != {(frames, N_IMG, N_IMG): 12}:
                fail(f"video qa launcher {tag} {i}: launches {r['launches']}, plain "
                     f"{r['plain']}, flash shapes {dict(r['delta']['flash_fwd_shapes'])}; "
                     f"expected {want} at {frames} frames")
    n_eval = len(evals)
    tiny = collections.Counter()
    for want, k in ((want_step, N_QA_STEPS), (want_eval, n_eval)):
        for shape, m in want["tiny_fwd"].items():
            tiny[shape] += m * k
    check_launcher_counts(
        "video qa launcher", counts, 12 * (N_QA_STEPS + n_eval), 12 * N_QA_STEPS,
        {"tiny_fwd": dict(tiny),
         "tiny_bwd": {k: m * N_QA_STEPS for k, m in want_step["tiny_bwd"].items()}})

    # --resume from the state saved at step 2
    saved = torch.load(os.path.join(out_resumed, "ckpt", ckpt_lib.TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=False)
    restored = {}
    orig_restore = ckpt_lib.restore_train_state

    def restore(ckpt_dir, model, optimizer):
        result = orig_restore(ckpt_dir, model, optimizer)
        copy = lambda t: t.detach().to("cpu", copy=True)
        restored.update(params={n: copy(p) for n, p in model.named_parameters()},
                        mu=dict(zip(optimizer.names, map(copy, optimizer.mu))),
                        nu=dict(zip(optimizer.names, map(copy, optimizer.nu))),
                        count=optimizer.count)
        return result

    t2 = time.perf_counter()
    run_name[0] = "resumed"
    steps_before = len(steps)
    ckpt_lib.restore_train_state = restore
    patch(True)
    try:
        run_mod.main(argv + ["--output_dir", out_resumed, "--resume"])
    finally:
        patch(False)
        ckpt_lib.restore_train_state = orig_restore
    same = bool(restored) and saved["step"] == QA_RESUME_STEP and \
        restored["count"] == saved["count"] and all(
            restored[part].keys() == saved[part].keys() and
            all(torch.equal(restored[part][k], saved[part][k]) for k in saved[part])
            for part in ("params", "mu", "nu"))
    same_batches = batches["resumed"] == batches["whole"][QA_RESUME_STEP:]
    log(f"phase 13b --resume from step {saved['step']}: {part_done('13b', 'resume', t2):.1f} s; "
        f"restored state equal to the saved one bit for bit: {same}; its "
        f"{len(batches['resumed'])} batches equal to the whole run's steps "
        f"{QA_RESUME_STEP + 1}-{N_QA_STEPS} bit for bit: {same_batches} "
        f"({len(steps) - steps_before} steps)")
    if not same or not same_batches or len(steps) - steps_before != \
            N_QA_STEPS - QA_RESUME_STEP:
        fail("video qa launcher --resume: the restored state or the batches after it differ "
             "from the whole run's")
    del saved, restored
    steps = steps[:steps_before]

    # 13c: the fine-tuned weights on 2 videos, card bf16 against CPU fp32 (deferred)
    state = load_params(os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE))
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(out_resumed, ignore_errors=True)
    cfg["num_labels"] = N_QA_ANSWERS
    train_ds, _ = create_dataset("video_qa", cfg, rng=random.Random(args.seed))
    samples = [train_ds[0], train_ds[1]]
    for s in samples:
        s["labels"] = np.int32(max(int(s["labels"]), 0))   # an answer off the list: class 0
    t_hold = time.perf_counter()
    defer_hold(f"phase 13c video QA card bf16 vs CPU fp32 (2 videos x {QA_FRAMES} frames, "
               f"dropout off)", video_qa_hold, hold_state(state, "video_qa.pt"),
               xvlm_config_from_yaml(cfg), samples, dev)
    part_done("13b", "hold", t_hold)
    phase_seconds("13b", t0)
    return split_counts(counts, [r["delta"] for r in steps])


def video_launcher_phase(args, root: str, th_path: str, tok_dir: str, words, dev,
                         smi: str = "") -> dict:
    """Phase 13: 13a, the stage-2 stream's hold on 2 videos (13c), then 13b.
    Every file the phase writes (corpora, configs, train states, the
    ``.th``) goes to ``work_dir``: phases 7-12 write most of the call's
    disk-write cap. Returns the launches of 13a's first run and of 13b, by
    operands."""
    work = work_dir(root, 24 * 2**30)
    try:
        th13, final, mcfg, pre = video_pretrain_phase(args, root, th_path, tok_dir, words,
                                                      work, dev, smi)
        torch.cuda.empty_cache()
        defer_hold(f"phase 13c video stream card bf16 vs CPU fp32 (2 videos x {STREAM_FRAMES} "
                   f"frames, negatives injected, dropout off)", video_pretrain_hold,
                   hold_state(final, "video_pretrain.pt"), mcfg, dev)
        del final
        qa = video_qa_phase(args, root, th13, tok_dir, words, work, dev, smi)
    finally:
        if work != root:
            shutil.rmtree(work, ignore_errors=True)
    return {"training": {k: collections.Counter(pre[k]) + qa["training"][k]
                         for k in LEDGER_PARTS},
            "serving": qa["serving"]}



# ---- phase 14: the Plus / CCLM base (XLM-R text tower, cross encoder) ----

CCLM_CONFIG = "configs/pretrain/cclm_x2vlm_base.yaml"
CCLM_LANGS = ("en", "de", "fr", "cs", "ja", "zh", "ru", "es")   # the config's image languages
N_PARA_LINES = 2 * PARA_PAIRS        # 14: parallel lines, two steps' worth
CCLM_STEPS, CCLM_RESUME_STEP = 2, 1  # 14: 2 steps, then --resume from the state of step 1
# characters of the image captions' scripts beside the corpus words, each a
# piece of the written vocabulary (with and without the word-start mark)
CCLM_SCRIPT_CHARS = ("一二三四五六七八九十人大小中上下山水火木金土日月犬猫"
                     "あいうえおかきくけこさしすせそ"
                     "абвгдежзийклмнопрстуфхцчшщыэюя"
                     "àâäçéèêëîïôöùûüñßčďěňřšťůž")


def write_xlmr_tokenizer(root: str, words) -> str:
    """``root/xlm-roberta-base/tokenizer.json`` of XLM-R's size and layout:
    ``<s> <pad> </s> <unk>``, a piece for each of ``words`` and each script
    character, filler pieces, ``<mask>`` last: ``XLMR_VOCAB`` entries, so
    the masking's random replacement and the MLM head span the real table.
    NFKC with space runs folded, Metaspace, a Unigram with unk id 3."""
    vocab, seen = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]], set()
    seen.update(p for p, _ in vocab)

    def add(piece, score):
        if piece not in seen:
            seen.add(piece)
            vocab.append([piece, score])

    for w in words:
        add("▁" + w, -8.0 - 0.05 * len(w))
    for ch in CCLM_SCRIPT_CHARS:
        add("▁" + ch, -10.5)
        add(ch, -11.0)
    i = 0
    while len(vocab) < XLMR_VOCAB - 1:
        add(f"▁x{i}q", -14.0)
        i += 1
    vocab.append(["<mask>", 0.0])
    special = [(0, "<s>"), (1, "<pad>"), (2, "</s>"), (3, "<unk>"), (XLMR_VOCAB - 1, "<mask>")]
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False,
                              "lstrip": t == "<mask>", "rstrip": False, "normalized": False,
                              "special": True} for i, t in special],
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "NFKC"},
                {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                              "prepend_scheme": "always", "split": True},
            "post_processor": None, "decoder": None,
            "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": False}}
    tok_dir = os.path.join(root, "xlm-roberta-base")
    os.makedirs(tok_dir)
    with open(os.path.join(tok_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return tok_dir


def cclm_caption(rng: np.random.Generator, words, lang: str, lo: int = 6, hi: int = 30) -> str:
    """A caption of ``words``, with characters of ``lang``'s script mixed in."""
    text = caption(rng, words, lo, hi).split()
    script = {"zh": CCLM_SCRIPT_CHARS[:25], "ja": CCLM_SCRIPT_CHARS[25:40],
              "ru": CCLM_SCRIPT_CHARS[40:70]}.get(lang, CCLM_SCRIPT_CHARS[70:])
    for j in rng.integers(0, len(text), max(1, len(text) // 3)):
        text[j] = "".join(rng.choice(list(script), int(rng.integers(1, 4))))
    return " ".join(text)


def write_cclm_corpus(root: str, work: str, rng: np.random.Generator, words):
    """Phase 7's image lines with captions keyed by some of the config's
    eight languages, and ``N_PARA_LINES`` parallel lines (``text1`` /
    ``text2`` of two languages; a few with ``text`` for ``text1``)."""
    img_file, para_file = os.path.join(work, "images_ml.jsonl"), os.path.join(work, "para.jsonl")
    with open(os.path.join(root, "images.jsonl")) as src, open(img_file, "w") as f:
        for line in src:
            langs = [lang for lang in CCLM_LANGS if rng.random() < 0.6] or ["en"]
            f.write(json.dumps({"binary": json.loads(line)["binary"],
                                "caption": {lang: cclm_caption(rng, words, lang)
                                            for lang in langs}}, ensure_ascii=False) + "\n")
    with open(para_file, "w") as f:
        for i in range(N_PARA_LINES):
            a, b = rng.choice(CCLM_LANGS, 2, replace=False)
            f.write(json.dumps({"text1" if i % 7 else "text": cclm_caption(rng, words, a, 10, 60),
                                "text2": cclm_caption(rng, words, b, 10, 60)},
                               ensure_ascii=False) + "\n")
    return img_file, para_file


def cclm_stream_launches(stream: str, B: int = PRETRAIN_BATCH, R: int = REGION_ROWS,
                         P: int = PARA_PAIRS, n_text: int = 12) -> dict:
    """The tiny launches of one call of a CCLM stream (forward and backward
    alike), 64-token texts through XLM-R's ``n_text`` layers and the 6 cross
    layers: the image stream (the clean and the masked text, ITM over 3 x
    ``B`` rows, MLM over ``B``), the region stream (the same over ``R`` rows
    with region key masks, and the bbox pass) and the parallel text (both
    languages and the masked text; TTM over 3 x ``P`` rows and TLM, language
    2 as the keys)."""
    L = CCLM_LEN
    if stream == "image":
        return {(B, L, L): 2 * n_text + 6, (3 * B, L, L): 6, (3 * B, L, 200): 6, (B, L, 200): 6}
    if stream == "region":
        return {(R, L, L): 2 * n_text + 12, (3 * R, L, L): 6, (3 * R, L, 200): 6,
                (R, L, 200): 12}
    return {(P, L, L): 3 * n_text + 12, (3 * P, L, L): 12}


def cclm_cosine_params():
    """Gradients held to the CPU path: the vision tower, XLM-R's embeddings
    (the tied 250,002-row MLM decoder) and a layer, the cross encoder's
    self- and cross-attention, the MLM head, the ITM and bbox heads."""
    return ("base.vision_encoder.blocks.0.attn.qkv.weight",
            "base.vision_encoder.blocks.0.attn.relative_position_bias_table",
            "base.text_encoder.roberta.embeddings.word_embeddings.weight",
            "base.text_encoder.roberta.encoder.layer.0.attention.self.query.weight",
            "base.cross_encoder.encoder.layer.0.attention.self.query.weight",
            "base.cross_encoder.encoder.layer.0.crossattention.self.key.weight",
            "base.text_encoder.lm_head.dense.weight", "base.itm_head.0.weight",
            "base.bbox_head.0.weight")


def cclm_hold_batches(mcfg):
    """2 images with 64-token texts, 2 region rows over 2 images, 2
    parallel pairs; 4 masked positions a row, the last row padded."""
    g = torch.Generator().manual_seed(14)
    res, side = mcfg.vision.image_res, mcfg.vision.image_res // mcfg.vision.patch_size

    def texts(pad_from):
        ids = torch.randint(5, XLMR_VOCAB - 1, (2, CCLM_LEN), generator=g)
        ids[:, 0] = 0
        atts = torch.ones(2, CCLM_LEN, dtype=torch.int32)
        atts[1, pad_from:] = 0
        ids = ids * atts
        pos = torch.tensor([[3, 7, 9, 15], [2, 5, 20, 30]])
        masked = ids.clone()
        masked[torch.arange(2)[:, None], pos] = XLMR_VOCAB - 1
        return {"text_ids": ids, "text_atts": atts, "text_ids_masked": masked,
                "masked_pos": pos, "masked_ids": torch.gather(ids, 1, pos)}

    image = dict(texts(40), image=torch.randint(0, 256, (2, res, res, 3), generator=g,
                                                dtype=torch.uint8))
    grid = torch.zeros(2, side, side)
    grid[0, 4:10, 3:8] = 1
    grid[1, 2:7, 6:10] = 1
    region = dict(texts(33), image=torch.randint(0, 256, (2, res, res, 3), generator=g,
                                                 dtype=torch.uint8),
                  image_atts=torch.cat([torch.ones(2, 1), grid.view(2, -1)], 1),
                  idx_to_group_img=torch.tensor([0, 1]), target_bbox=torch.zeros(2, 4),
                  is_image=torch.zeros(2))
    second = texts(50)
    para = dict(texts(45), text_ids_2=second["text_ids"], text_atts_2=second["text_atts"])
    return image, region, para


def cclm_hold(final, mcfg, dev, with_pairs: bool = True) -> tuple:
    """The run's weights ``final`` (or the train state saved at that path)
    on 2 images, 2 region rows and 2 parallel pairs,
    dropout off, the negatives injected: the card in bf16 against the
    port's CPU fp32 path: each loss (ITC, ITM, MLM of the image and the
    region stream, bbox L1 and GIoU; TTC, TTM, TLM) within 0.05 + 2%,
    gradient cosines of ``cclm_cosine_params`` >= 0.99, and each bf16 call
    into K5 and K6 with 200 keys (the image) or 64 (XLM-R's self-attention,
    the cross encoder's, language 2 as the keys) held on the model's
    operands within ``FUSION_CALL_RATIO`` of the bf16 rule's bound. The
    box targets are ``off_kink_targets`` of the CPU path's boxes. Without
    ``with_pairs`` the parallel pairs stay out (phase 21: CCLM-large's text tower
    is narrower than its vision tower, and the pairs' cross-attention to
    language 2 raises in both packages; ROADMAP C)."""
    final = params_of(final)
    from x2vlm_tpu_torch.models import XVLMPlusForPretrain

    image, region, para = cclm_hold_batches(mcfg)
    neg = (torch.tensor([1, 0]), torch.tensor([1, 0]))
    names = cclm_cosine_params()
    ratios = {(kind, n): [] for kind in ("forward", "backward") for n in (200, CCLM_LEN)}
    losses, grads = {}, {}
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        model = XVLMPlusForPretrain(mcfg, dtype=dtype, device=device, seed=None)
        model.load_state_dict(final)
        to = lambda b: {k: v.to(device) for k, v in b.items()}
        negs = tuple(t.to(device) for t in neg)
        if tag == "cpu":
            region["target_bbox"] = off_kink_targets(cpu_boxes(
                model, model.base.bbox_head,
                lambda: model(to(region), neg_idx=negs, ret_bbox_loss=True)))
        with held_tiny_calls(200, ratios[("forward", 200)]), \
                held_tiny_calls(CCLM_LEN, ratios[("forward", CCLM_LEN)]), \
                held_tiny_bwd_calls(200, ratios[("backward", 200)]), \
                held_tiny_bwd_calls(CCLM_LEN, ratios[("backward", CCLM_LEN)]):
            out = {f"image_{k}": v for k, v in model(to(image), neg_idx=negs).items()}
            out.update({f"region_{k}": v for k, v in model(
                to(region), neg_idx=negs, ret_bbox_loss=True).items()})
            if with_pairs:
                out.update({f"para_{k}": v for k, v in model(to(para), neg_idx=negs).items()})
            sum(out.values()).backward()
        losses[tag] = {k: v.item() for k, v in out.items()}
        params = dict(model.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1) for k in names}
        del model, out, params
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in names}
    r = {"losses": losses, "cosine": cos,
         "ratios": {f"{kind} {n} keys": [round(x, 3) for x in v]
                    for (kind, n), v in ratios.items()}}
    faults = []
    want = {"image_loss_itc", "image_loss_itm", "image_loss_mlm", "region_loss_itc",
            "region_loss_itm", "region_loss_mlm", "region_loss_bbox", "region_loss_giou"}
    if with_pairs:
        want |= {"para_loss_ttc", "para_loss_ttm", "para_loss_mlm"}
    if set(losses["card"]) != want:
        faults.append(f"losses {sorted(losses['card'])}, expected {sorted(want)}")
    for k, ref in losses["cpu"].items():
        if not abs(losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            faults.append(f"{k}: card {losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    # 200 keys: ITM + MLM of the images, ITM + MLM + bbox of the regions (a
    # call each a cross layer); 64 keys: 7 text passes a XLM-R layer (4
    # without the pairs), and a cross layer the 7 cross passes'
    # self-attention and TTM's and TLM's cross-attention to language 2 (the
    # 5 of the images and regions without them)
    for (kind, n), v in ratios.items():
        expect = (5 * mcfg.num_cross_layers if n == 200 else
                  (7 if with_pairs else 4) * mcfg.text.num_layers +
                  (9 if with_pairs else 5) * mcfg.num_cross_layers)
        if len(v) != expect or not all(x <= FUSION_CALL_RATIO for x in v):
            faults.append(f"the {kind} calls with {n} keys: {len(v)} held (expected "
                          f"{expect}), errors over the bf16 rule's bound up to "
                          f"{max(v, default=float('nan')):.3f} (at most {FUSION_CALL_RATIO})")
    return r, faults


def fused_ce_times(dev, smi: str) -> None:
    """The MLM head's fused vocabulary CE at XLM-R's 250,002 rows, forward
    and backward in bf16 at the image and region streams' masked rows (128
    rows x 16 masks), against the same function on the full logits (one matmul and
    ``F.cross_entropy``): CUDA events, the card ahead of the host."""
    from x2vlm_tpu_torch.ops.fused_ce import fused_vocab_ce

    gen = torch.Generator(device=dev).manual_seed(14)
    table = (torch.randn(XLMR_VOCAB, 768, generator=gen, device=dev) * 0.02).requires_grad_()
    bias = torch.zeros(XLMR_VOCAB, device=dev, requires_grad=True)
    out = {}
    for n in (PRETRAIN_BATCH * 16,):
        h = torch.randn(n, 768, generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
        labels = torch.randint(0, XLMR_VOCAB, (n,), generator=gen, device=dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)

        def fused():
            torch.autograd.grad(fused_vocab_ce(h, table, bias, labels, valid), (h, table, bias))

        def full():
            logits = (h @ table.to(torch.bfloat16).t()).float() + bias
            torch.autograd.grad(F.cross_entropy(logits, labels), (h, table, bias))

        out[n] = {"fused_ms": time_ms(fused, inner=3, reps=5, host_ahead=True),
                  "full_logits_ms": time_ms(full, inner=3, reps=5, host_ahead=True)}
    log(f"phase 14 fused vocab CE at {XLMR_VOCAB} rows, D=768, bf16, forward + backward "
        f"(CUDA events; by masked rows; {smi}): {json.dumps(out)}")


def cclm_launcher_phase(args, root: str, th_path: str, words, work: str, dev,
                        smi: str = "") -> tuple:
    """Phase 14: ``x2vlm_tpu_torch.run --task pretrain`` in process on the
    shipped ``cclm_x2vlm_base.yaml`` from phase 7's ``.th`` (``is_xvlm_ckpt``
    with ``replace_text_encoder``: the cross encoder from its text layers
    12-17, the XLM-R tower fresh from ``--seed``), a written 250,002-entry
    XLM-R ``tokenizer.json``, phase 7's images with captions in the
    config's languages, phase 7's (monolingual) region lines and
    ``N_PARA_LINES`` parallel lines; the image (128 a step), region (128
    rows over 50 images) and parallel-text (128 pairs of 64 tokens) blocks
    as shipped. 2 steps, then ``--resume`` from the state of step 1,
    its state and cursors (the parallel text's among them) restored bit for
    bit; each stream's calls timed and their launches read; then
    ``cclm_hold``. Every file goes to ``work`` (``work_dir``); the first
    run's last state (``out_cclm/ckpt``) and the tokenizer stay there for
    phase 15. Returns the launches of the first run and ``{"tok_dir",
    "ckpt"}``."""
    from x2vlm_tpu_torch import run as run_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 14)
    tok_dir = write_xlmr_tokenizer(work, words)
    img_file, para_file = write_cclm_corpus(root, work, rng, words)
    shipped = shipped_config(CCLM_CONFIG)
    cfg = dict(shipped, train_file=[img_file], train_file_regions=[os.path.join(root,
                                                                                "regions.jsonl")],
               train_file_mtext=[para_file], text_encoder=tok_dir,
               train_dataset_size=PRETRAIN_BATCH,       # 1 step an epoch: a save each step
               ckpt_frequent=1, ckpt_frequent_step=1000)
    sizes = (cfg["model_type"], cfg["is_xvlm_ckpt"], cfg["replace_text_encoder"],
             cfg["images"]["batch_size"], cfg["regions"]["batch_size"],
             cfg["regions"]["max_images"],
             cfg["mtexts"]["batch_size"], cfg["mtexts"]["max_tokens"], cfg["max_tokens"],
             cfg["text_num_hidden_layers"], cfg["num_cross_layers"],
             tuple(cfg["images"]["languages"]), cfg["regions"].get("languages"))
    if sizes != ("cclm", True, True, PRETRAIN_BATCH, REGION_ROWS, REGION_IMAGES, PARA_PAIRS,
                 CCLM_LEN, CCLM_LEN, 12, 6, CCLM_LANGS, None):
        fail(f"cclm launcher: the shipped config's sizes {sizes} changed")
    cfg_path = os.path.join(work, "cclm.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out, out_resumed = os.path.join(work, "out_cclm"), os.path.join(work, "out_cclm_resumed")
    argv = ["--task", "pretrain", "--config", cfg_path, "--checkpoint", th_path, "--seed",
            str(args.seed), "--device", dev.type, "--epoch", str(CCLM_STEPS)]
    log(f"phase 14 data and config: {part_done('14', 'data', t0):.1f} s")

    imported = {}
    orig = {"load": ckpt_lib.load_converted, "save": ckpt_lib.save_train_state}

    def load(model, sd):
        imported["missing"], imported["unexpected"] = orig["load"](model, sd)
        imported["fresh_text"] = sorted(
            n for n, _ in model.base.named_parameters()
            if n.startswith("text_encoder.roberta.") or n == "text_encoder.lm_head.bias")
        return imported["missing"], imported["unexpected"]

    def save(ckpt_dir, model, optimizer, step, data_state=None):
        if ckpt_dir.startswith(out_resumed):     # the resumed run saves nothing
            return os.path.join(ckpt_dir, ckpt_lib.TRAIN_STATE_FILE)
        path = orig["save"](ckpt_dir, model, optimizer, step, data_state)
        if step == CCLM_RESUME_STEP:   # kept for --resume: a link, not a copy
            os.makedirs(os.path.join(out_resumed, "ckpt"))
            os.link(path, os.path.join(out_resumed, "ckpt", ckpt_lib.TRAIN_STATE_FILE))
        return path

    t1 = time.perf_counter()
    reset_counts()
    ckpt_lib.load_converted, ckpt_lib.save_train_state = load, save
    try:
        with StreamTimer({(k, CCLM_STEPS - 1) for k in ("image", "region", "mtext")}
                         if args.profile else None,
                         (args, smi, "chip_smoke_cclm_{stream}_profile.txt")) as timer:
            record = run_mod.main(argv + ["--output_dir", out])
        check_data_plane("phase 14", record)
    finally:
        ckpt_lib.load_converted, ckpt_lib.save_train_state = orig["load"], orig["save"]
    torch.cuda.synchronize()
    counts1 = launch_counts()
    log(f"phase 14 run 1 ({CCLM_STEPS} steps): {part_done('14', 'run', t1):.1f} s; "
        f"{json.dumps(record)}")
    log(f"phase 14 import of {th_path}: {len(imported.get('missing') or [])} missing (fresh), "
        f"unexpected {imported.get('unexpected')}")
    if imported.get("missing") != imported.get("fresh_text") or imported.get("unexpected"):
        fail(f"cclm launcher import: missing {imported.get('missing')}, unexpected "
             f"{imported.get('unexpected')}; expected XLM-R and the MLM decoder bias fresh, "
             f"the cross encoder from the .th's text layers 12-17")
    losses = [f"{s}_loss_{k}" for s in ("image", "region") for k in ("itc", "itm", "mlm")] + \
        ["region_loss_bbox", "region_loss_giou", "mtext_loss_ttc", "mtext_loss_ttm",
         "mtext_loss_mlm"]
    if not all(isinstance(record.get(k), float) and math.isfinite(record[k]) for k in losses) \
            or record.get("broken", -1) != 0:
        fail(f"cclm launcher: losses {[record.get(k) for k in losses]}, broken "
             f"{record.get('broken')}")
    n = CCLM_STEPS
    want_tiny = collections.Counter()
    for stream in ("image", "region", "mtext"):
        want_tiny.update({k: v * n for k, v in cclm_stream_launches(stream).items()})
    check_launcher_counts("cclm launcher", counts1, 24 * n, 24 * n,
                          {"tiny_fwd": dict(want_tiny), "tiny_bwd": dict(want_tiny)})
    for stream, flash in (("image", {(PRETRAIN_BATCH, N_IMG, N_IMG): 12}),
                          ("region", {(REGION_IMAGES, N_IMG, N_IMG): 12}), ("mtext", {})):
        calls = timer.calls[stream]
        if len(calls) != n:
            fail(f"cclm launcher: {len(calls)} {stream}-stream calls, expected {n}")
        for i, c in enumerate(calls):
            tag = f"cclm launcher {stream} step {i}"
            want = cclm_stream_launches(stream)
            check_launcher_counts(tag, c["launches"], 12 if flash else 0, 12 if flash else 0,
                                  {"tiny_fwd": want, "tiny_bwd": want})
            if dict(c["launches"]["flash_fwd_shapes"]) != flash:
                fail(f"{tag}: flash shapes {dict(c['launches']['flash_fwd_shapes'])}, "
                     f"expected {flash}")
    log(f"phase 14 by stream (CUDA-event ms and wall ms of each call, median; peak GiB; "
        f"apply: the AdamW step; {smi}): {json.dumps(timer.summary())}")
    log(f"phase 14 calls (CUDA-event ms, wall ms, peak GiB): " + json.dumps(
        {k: [[round(c["ms"], 3), round(c["wall_ms"], 3), round(c["peak_gib"], 2)] for c in v]
         for k, v in timer.calls.items()}))

    # --resume from the state of step 1: restored bit for bit, cursors included
    saved = torch.load(os.path.join(out_resumed, "ckpt", ckpt_lib.TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=False)
    seen = {}
    orig_resume = run_mod.maybe_resume

    def resumed(a, model, optimizer):
        step, data_state = orig_resume(a, model, optimizer)
        params = dict(model.named_parameters())
        seen.update(
            step=step, data_state=data_state,
            params=all(torch.equal(params[k].detach().cpu(), v)
                       for k, v in saved["params"].items()),
            mu=all(torch.equal(m.cpu(), saved["mu"][k])
                   for k, m in zip(optimizer.names, optimizer.mu)),
            nu=all(torch.equal(v.cpu(), saved["nu"][k])
                   for k, v in zip(optimizer.names, optimizer.nu)),
            count=optimizer.count == saved["count"])
        return step, data_state

    t2 = time.perf_counter()
    run_mod.maybe_resume, ckpt_lib.save_train_state = resumed, save
    try:
        record2 = run_mod.main(argv + ["--output_dir", out_resumed, "--resume"])
    finally:
        run_mod.maybe_resume, ckpt_lib.save_train_state = orig_resume, orig["save"]
    torch.cuda.synchronize()
    log(f"phase 14 run 2 (--resume from step {CCLM_RESUME_STEP}): "
        f"{part_done('14', 'resume', t2):.1f} s; resumed at step {seen.get('step')}, data "
        f"cursors {seen.get('data_state')}; equal to the saved state: params "
        f"{seen.get('params')}, mu {seen.get('mu')}, nu {seen.get('nu')}, count "
        f"{seen.get('count')}; {json.dumps(record2)}")
    if not (seen.get("step") == CCLM_RESUME_STEP and seen.get("params") and seen.get("mu")
            and seen.get("nu") and seen.get("count")
            and seen.get("data_state") == saved["data_state"]
            and set(saved["data_state"]) == {"image", "region", "mtext"}):
        fail(f"cclm launcher --resume: {seen} against the saved step {saved['step']}")
    if record2.get("pretrain_steps") != [CCLM_RESUME_STEP, CCLM_STEPS] or \
            record2.get("broken", -1) != 0:
        fail(f"cclm launcher --resume: {record2}")
    del saved
    shutil.rmtree(out_resumed, ignore_errors=True)

    t3 = time.perf_counter()
    defer_hold("phase 14 card bf16 vs CPU fp32 (2 images, 2 region rows, 2 parallel pairs; "
               "negatives injected, dropout off)", cclm_hold,
               os.path.join(out, "ckpt", ckpt_lib.TRAIN_STATE_FILE), xvlm_config_from_yaml(cfg),
               dev)
    part_done("14", "hold", t3)
    torch.cuda.empty_cache()
    fused_ce_times(dev, smi)
    phase_seconds("14", t0)
    return counts1, {"tok_dir": tok_dir, "ckpt": os.path.join(out, "ckpt")}


# ---- phase 15: the IGLUE tasks on the Plus / CCLM base at 384 px ----

IGLUE_TASKS = ("xvnli", "marvl", "xgqa", "wit", "xflickrco")
IGLUE_LANGS = ("de", "zh")            # the test sets' languages (MARVL's: NLVR2's "en", "zh")
# WIT's and xFlickrCO's one test language: each language's eval reranks
# 128 x 128 pairs both ways at 80 tokens in the plain fp32 core (~8 s of
# the script a language)
RET_EVAL_LANGS = IGLUE_LANGS[:1]
N_IGLUE_TRAIN = 2 * IGLUE_BATCH       # train lines: 2 steps (xGQA: 1 an epoch, 2 epochs)
N_RET_EVAL = 128                      # WIT / xFlickrCO test lines a language: k_test 128 both ways
N_XGQA_ANSWERS = 1000                 # xGQA's answer lists (each language's own)
XVNLI_FEWSHOT = f"de,{IGLUE_BATCH}"   # the few-shot run: 16 German train lines, 1 step
XGQA_RESUME_STEP = 1                  # --resume from the state of step 1 (of 2)
IGLUE_CONFIGS = {task: f"configs/finetune/{task}_cclm_base.yaml" for task in IGLUE_TASKS}


def write_iglue_corpus(work: str, rng: np.random.Generator, words, image_root: str) -> dict:
    """Each task's data over phase 8's PNGs, captions in the test
    languages' scripts (``cclm_caption``): XVNLI lines (``<id>.jpg`` names
    linked to the PNGs, a line without a label dropped), NLVR2 train and
    ``en`` test lines and MARVL ``zh`` lines for MARVL, xGQA's questions and
    an answer list of ``N_XGQA_ANSWERS`` a language (``zh`` a [path, list]
    pair), WIT lines with the PNGs in base64 and xFlickrCO lines, both with
    captions long enough to fill 80 tokens; ``N_IGLUE_TRAIN`` train lines
    (16 for xGQA and the few-shot file), 32 test lines a language (128 for
    WIT and xFlickrCO, in ``RET_EVAL_LANGS`` only). Returns the paths by
    name."""
    n_img = len([f for f in os.listdir(image_root) if f.endswith(".png")])
    d = os.path.join(work, "iglue")
    os.makedirs(os.path.join(d, "jpg"))
    paths = {}

    def dump(name, data, lines=True):
        paths[name] = os.path.join(d, name)
        with open(paths[name], "w", encoding="utf-8") as f:
            if lines:
                f.writelines(json.dumps(r, ensure_ascii=False) + "\n" for r in data)
            else:
                json.dump(data, f, ensure_ascii=False)

    def img():
        return int(rng.integers(n_img))

    for i in range(n_img):    # XVNLI names its images <Flikr30kID>.jpg
        os.symlink(os.path.join(image_root, f"{i}.png"),
                   os.path.join(d, "jpg", f"{1000 + i}.jpg"))
    labels = ("contradiction", "entailment", "neutral")

    def xvnli(n, lang):
        return [{"Flikr30kID": str(1000 + img()), "gold_label": labels[int(rng.integers(3))],
                 "sentence2": cclm_caption(rng, words, lang, 4, 30)} for _ in range(n)] + \
            [{"Flikr30kID": "1000", "gold_label": "-", "sentence2": "x"}]

    dump("xvnli_train_en.jsonl", xvnli(N_IGLUE_TRAIN, "en"))
    dump(f"xvnli_{XVNLI_FEWSHOT.replace(',', '_')}.jsonl", xvnli(IGLUE_BATCH, "de"))
    for lang in IGLUE_LANGS:
        dump(f"xvnli_test_{lang}.jsonl", xvnli(IGLUE_EVAL_BATCH, lang))

    def nlvr(n):
        return [{"images": [f"{img()}.png", f"{img()}.png"], "label": str(rng.random() < 0.5),
                 "sentence": cclm_caption(rng, words, "en", 4, 30)} for _ in range(n)]

    dump("nlvr_train.json", nlvr(N_IGLUE_TRAIN), lines=False)
    dump("nlvr_test_en.json", nlvr(IGLUE_EVAL_BATCH), lines=False)
    dump("marvl_test_zh.jsonl", [
        {"left_img": f"{img()}.png", "right_img": f"{img()}.png", "label": rng.random() < 0.5,
         "caption": cclm_caption(rng, words, "zh", 4, 30)} for _ in range(IGLUE_EVAL_BATCH)])

    answers = sorted({cclm_caption(rng, words, "en", 1, 4) for _ in range(2 * N_XGQA_ANSWERS)})
    answers = [answers[i] for i in rng.permutation(len(answers))[:N_XGQA_ANSWERS]]
    dump("gqa_answers.json", answers, lines=False)
    dump("gqa_answers_zh.json", answers[::-1], lines=False)

    def gqa(n, lang, first_id):
        return [{"image": f"{img()}.png", "question_id": first_id + i,
                 "question": cclm_caption(rng, words, lang, 4, 30),
                 "answer": answers[int(rng.integers(N_XGQA_ANSWERS))]} for i in range(n)]

    dump("gqa_train.json", gqa(IGLUE_BATCH, "en", 0), lines=False)
    for j, lang in enumerate(IGLUE_LANGS):
        dump(f"gqa_test_{lang}.json", gqa(IGLUE_EVAL_BATCH, lang, 1000 * (j + 1)), lines=False)

    pngs = []
    for i in range(n_img):
        with open(os.path.join(image_root, f"{i}.png"), "rb") as f:
            pngs.append(base64.b64encode(f.read()).decode())

    def wit(n, lang):
        return [{"image_url": f"https://example.org/{lang}/{i}.png",
                 "image_content": pngs[img()],
                 "caption_reference_description": cclm_caption(rng, words, lang, 60, 90)}
                for i in range(n)]

    def xflickrco(n, lang):
        return [{"id": f"{lang}{i}", "img_path": f"{img()}.png",
                 "sentences": [cclm_caption(rng, words, lang, 60, 90)]} for i in range(n)]

    for name, make in (("wit", wit), ("xflickrco", xflickrco)):
        dump(f"{name}_train_en.jsonl", make(N_IGLUE_TRAIN, "en"))
        for lang in RET_EVAL_LANGS:
            dump(f"{name}_test_{lang}.jsonl", make(N_RET_EVAL, lang))
    return paths


def iglue_config(task: str, paths: dict, plus: dict, image_root: str) -> dict:
    """The task's shipped config (its own sizes), the data paths pointed at
    ``paths``, the tokenizer phase 14 wrote."""
    cfg = dict(shipped_config(IGLUE_CONFIGS[task]), text_encoder=plus["tok_dir"])
    per_lang = lambda stem, ext, langs=IGLUE_LANGS: {  # noqa: E731
        lang: paths[f"{stem}_test_{lang}.{ext}"] for lang in langs}
    if task == "xvnli":
        cfg.update(train_file=[paths["xvnli_train_en.jsonl"]],
                   test_file=per_lang("xvnli", "jsonl"),
                   image_root=os.path.dirname(paths["xvnli_train_en.jsonl"]) + "/jpg")
    elif task == "marvl":
        cfg.update(train_file=[paths["nlvr_train.json"]], image_root=image_root,
                   marvl_image_root=image_root,
                   test_file={"en": paths["nlvr_test_en.json"],
                              "zh": paths["marvl_test_zh.jsonl"]})
    elif task == "xgqa":
        cfg.update(train_file=[paths["gqa_train.json"]], vqa_root=image_root,
                   answer_list=paths["gqa_answers.json"], start_eval=1,
                   test_file={"de": paths["gqa_test_de.json"],
                              "zh": [paths["gqa_test_zh.json"], paths["gqa_answers_zh.json"]]})
    else:
        cfg.update(train_file=[paths[f"{task}_train_en.jsonl"]],
                   test_file=per_lang(task, "jsonl", RET_EVAL_LANGS))
        if task == "xflickrco":
            cfg["image_root"] = image_root
    return cfg


def iglue_launches(task: str, train: bool) -> dict:
    """The attention launches of one step (16 rows) or eval call (32 rows;
    WIT's and xFlickrCO's: one language's whole eval) of ``task`` on the Plus
    base: 12 flash over the images (S=577; MARVL's 2 a row); at 40 tokens
    tiny at 40 x 40 (XLM-R's 12 layers, each cross-encoder pass's 6
    self-attentions) and 40 x 584 (its 6 cross-attentions, key-tiled);
    xGQA's decoder cross-attention at 10 x 40 over the 32 answer rows (an
    eval: 1 x 40, then 10 x 40 over each 512-row chunk of the 32 x 128
    ranked answers) and its causal self-attention on the plain core; at 80
    tokens (WIT, xFlickrCO) no tiny launch: XLM-R's and the cross encoder's
    attention on the plain core (a step: the text pass, ITM over 3 x 16
    rows; an eval: the texts in one call of 256, the ITM rerank's 2 x 16
    calls of 1,024 rows). ``plain`` by (B, Sq, Skv); the backward's tiny
    launches are the forward's."""
    L, K, LONG = TEXT_LEN, N_KEYS_384, IGLUE_LONG
    B = IGLUE_BATCH if train else IGLUE_EVAL_BATCH
    if task in ("wit", "xflickrco"):
        if train:
            return {"flash_fwd": 12, "flash_bwd": 12, "tiny_fwd": {}, "tiny_bwd": {},
                    "plain": {(B, LONG, LONG): 12, (3 * B, LONG, LONG): 6,
                              (3 * B, LONG, K): 6}}
        n_rerank = 2 * N_RET_EVAL // 8
        return {"flash_fwd": 12 * N_RET_EVAL // B, "flash_bwd": 0, "tiny_fwd": {},
                "tiny_bwd": {},
                "plain": {(256, LONG, LONG): 12, (RERANK_BATCH, LONG, LONG): 6 * n_rerank,
                          (RERANK_BATCH, LONG, K): 6 * n_rerank}}
    passes = 2 if task == "marvl" else 1
    tiny = {(B, L, L): 12 + 6 * passes, (B, L, K): 6 * passes}
    plain = {}
    if task == "xgqa" and train:
        tiny[(XGQA_ANSWERS, ANSWER_LEN, L)] = 6
        plain = {(XGQA_ANSWERS, ANSWER_LEN, ANSWER_LEN): 6}
    elif task == "xgqa":
        chunks = B * K_TEST // XGQA_RANK_CHUNK
        tiny.update({(B, 1, L): 6, (XGQA_RANK_CHUNK, ANSWER_LEN, L): 6 * chunks})
        plain = {(B, 1, 1): 6, (XGQA_RANK_CHUNK, ANSWER_LEN, ANSWER_LEN): 6 * chunks}
    return {"flash_fwd": 12, "flash_bwd": 12 if train else 0, "tiny_fwd": tiny,
            "tiny_bwd": tiny if train else {}, "plain": plain}


def iglue_cosine_params(family: str):
    """Gradients held to the CPU path: the vision tower (K2 / K3, K4),
    XLM-R's table and a layer, the cross encoder's self- and
    cross-attention (K6 at 40 x 40 and 40 x 584 at 40 tokens) and the
    family's head (retrieval: the ITM head; xGQA: a decoder layer's causal
    self- and cross-attention and its head)."""
    x = "cross_encoder.encoder.layer.0"
    common = ("vision_encoder.blocks.0.attn.qkv.weight",
              "vision_encoder.blocks.0.attn.relative_position_bias_table",
              "text_encoder.roberta.embeddings.word_embeddings.weight",
              "text_encoder.roberta.encoder.layer.0.attention.self.query.weight",
              f"{x}.attention.self.query.weight", f"{x}.crossattention.self.key.weight")
    d = "text_decoder.roberta.encoder.layer.0"
    return common + {
        "retrieval": ("itm_head.0.weight", "itm_head.3.weight"),
        "nlvr": ("cls_head.0.weight", "cls_head.3.weight"),
        "classification": ("cls_head.0.weight", "cls_head.3.weight"),
        "vqa": (f"{d}.attention.self.query.weight", f"{d}.crossattention.self.key.weight",
                "text_decoder.lm_head.dense.weight", "text_decoder.lm_head.bias")}[family]


def iglue_pass(family: str, state: dict, cfg: dict, batch: dict, device, dtype,
               answers=None, ratios=None) -> dict:
    """One side of a phase-15 hold: the fine-tuned weights ``state`` of a
    head family on ``device`` in ``dtype`` (dropout off) over the 2 rows of
    ``batch``: the losses of one forward (retrieval with the negatives
    injected), the gradients of ``iglue_cosine_params``, the head's output
    read in that forward (the ITM head's logits over the 3 x 2 ITM rows,
    NLVR2's and XVNLI's logits) and, for xGQA, ``rank_answer`` over
    ``answers`` with ``K_TEST``. ``ratios`` (forward, backward lists): each
    bf16 40 x 584 tiny call held on the model's operands into them."""
    from x2vlm_tpu_torch.factory import build_model

    model, _ = build_model(cfg, family, device=device, dtype=dtype, seed=None)
    model.load_state_dict(state)
    b = {k: v.to(device) for k, v in batch.items()}
    res, kw, outs = {}, {}, []
    if family == "retrieval":
        kw["neg_idx"] = (torch.tensor([1, 0], device=device),) * 2
    if family == "vqa":
        with torch.no_grad():
            ids, probs = model.predict(dict({k: b[k] for k in (
                "image", "question_ids", "question_atts")}, **{
                    k: v.to(device) for k, v in answers.items()}), K_TEST)
        res["rank"] = (ids.cpu(), probs.float().cpu())
    head = getattr(model, "itm_head" if family == "retrieval" else "cls_head", None)
    hook = head.register_forward_hook(
        lambda mod, inp, out: outs.append(out.detach().float().cpu())) if head is not None \
        else None
    with (held_tiny_calls(N_KEYS_384, ratios[0]) if ratios else contextlib.nullcontext()), \
            (held_tiny_bwd_calls(N_KEYS_384, ratios[1]) if ratios else contextlib.nullcontext()):
        out = model(b, **kw)
        sum(out.values()).backward()
    if hook is not None:
        hook.remove()
        res["out"] = torch.cat(outs)
    res["losses"] = {k: v.item() for k, v in out.items()}
    params = dict(model.named_parameters())
    res["grads"] = {k: params[k].grad.detach().float().cpu().reshape(-1)
                    for k in iglue_cosine_params(family)}
    return res


def iglue_hold(family: str, state, cfg: dict, batch: dict, dev, answers=None) -> tuple:
    """A phase-15 hold: ``iglue_pass`` on the CPU in fp32 and on the card in
    bf16 with the trained weights ``state`` (or the state saved at that
    path), ``iglue_compare`` of the two."""
    state = params_of(state)
    cpu = iglue_pass(family, state, cfg, batch, torch.device("cpu"), torch.float32, answers)
    ratios = ([], [])
    card = iglue_pass(family, state, cfg, batch, dev, torch.bfloat16, answers, ratios)
    del state
    torch.cuda.empty_cache()
    return iglue_compare(family, cpu, card, ratios)


def iglue_compare(family: str, cpu: dict, card: dict, ratios) -> tuple:
    """A phase-15 hold's readings and faults, card bf16 against CPU fp32:
    losses within 0.05 + 2%, the head's outputs within 0.05 + 5% of their
    scale, gradient cosines >= 0.99, each 40 x 584 call forward and
    backward within ``FUSION_CALL_RATIO`` of the bf16 rule's bound (XVNLI's
    and xGQA's 6 cross-attentions, NLVR2's 12; none at retrieval's 80
    tokens, where the plain core runs), xGQA's first answers equal and its
    top-k scores within 0.05."""
    cos = {k: F.cosine_similarity(card["grads"][k].double(), cpu["grads"][k].double(),
                                  dim=0).item() for k in cpu["grads"]}
    r = {"losses": {"cpu": cpu["losses"], "card": card["losses"]}, "cosine": cos,
         "fwd_ratios": [round(x, 3) for x in ratios[0]],
         "bwd_ratios": [round(x, 3) for x in ratios[1]]}
    faults = []
    n_calls = {"retrieval": 0, "nlvr": 12, "classification": 6, "vqa": 6}[family]
    for kind, got in zip(("forward", "backward"), ratios):
        if len(got) != n_calls or not all(x <= FUSION_CALL_RATIO for x in got):
            faults.append(f"the 40 x {N_KEYS_384} {kind} calls' errors over the bf16 rule's "
                          f"bound {[round(x, 3) for x in got]}, expected {n_calls} at most "
                          f"{FUSION_CALL_RATIO}")
    if "out" in cpu:
        r["out_err"] = max_err(card["out"], cpu["out"])
        r["out_scale"] = cpu["out"].abs().max().item()
        if not r["out_err"] <= 0.05 + 0.05 * r["out_scale"]:
            faults.append(f"card outputs off the CPU fp32 path's by {r['out_err']:.4f} (scale "
                          f"{r['out_scale']:.4f})")
    if "rank" in cpu:
        r["first_answer"] = {"cpu": cpu["rank"][0][:, 0].tolist(),
                             "card": card["rank"][0][:, 0].tolist()}
        r["score_err"] = max_err(card["rank"][1], cpu["rank"][1])
        r["cpu_top_scores"] = cpu["rank"][1][:, :3].tolist()
        if r["first_answer"]["card"] != r["first_answer"]["cpu"]:
            faults.append(f"rank_answer's first answers {r['first_answer']}")
        if not r["score_err"] <= 0.05:
            faults.append(f"rank_answer's top-k scores off the CPU fp32 path's by "
                          f"{r['score_err']:.4f}")
    for k, ref in cpu["losses"].items():
        if not abs(card["losses"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            faults.append(f"{k}: card {card['losses'][k]:.5f} vs CPU fp32 {ref:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    return r, faults


def iglue_launcher_phase(args, root: str, plus: dict, words, work: str, dev,
                         smi: str = "") -> dict:
    """Phase 15: ``x2vlm_tpu_torch.run`` in process on the five shipped
    IGLUE configs at their own sizes (384 px; 16 rows a step, 32 an eval
    call; k_test 128; 40 tokens, WIT's and xFlickrCO's 80; xGQA's 10-token
    answers and 6-layer RoBERTa-form decoder), each from phase 14's Plus
    train state (``--checkpoint <dir>``: memory-mapped, parameters only, the
    task's head fresh), phase 14's 250,002-entry XLM-R tokenizer and
    ``write_iglue_corpus``'s data, ``{lang: path}`` test sets: 2 steps and
    the eval each (``--task xvnli`` ... ``--task xflickrco``); xGQA in 2
    epochs of a step, then ``--resume`` from the state of step 1 (state and
    the next batch bit for bit); XVNLI once more as ``--task
    classification`` (its ``dataset_type``) under ``--fewshot`` (a
    two-slot train template, a one-slot test template), one step and its
    eval. Each step and eval call timed (CUDA events and wall, peak memory)
    and its launches read against ``iglue_launches`` (plain calls by
    shape); xGQA's rank pass timed with its peak memory; each head family's
    ``iglue_hold`` on 2 rows (WIT's weights for retrieval at 80 tokens),
    deferred to the holds' worker as soon as its run has trained it. Only
    xGQA's run saves a train state (step 1's, in ``work``); each hold's
    trained state is saved for the worker (``hold_state``) beside the next
    run. Returns the launches, split into steps and evals."""
    import hashlib

    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.data.finetune import vqa_collate
    from x2vlm_tpu_torch.data.loader import collate
    from x2vlm_tpu_torch.models import XVLMForClassification, XVLMForNLVR, XVLMForVQA
    from x2vlm_tpu_torch.tasks import retrieval as retrieval_mod

    t0 = time.perf_counter()
    image_root = os.path.join(root, "flickr")
    paths = write_iglue_corpus(work, np.random.default_rng(args.seed + 15), words, image_root)
    cfgs = {task: iglue_config(task, paths, plus, image_root) for task in IGLUE_TASKS}
    for task, cfg in cfgs.items():
        sizes = (cfg["model_type"], cfg["image_res"], cfg["batch_size"], cfg["batch_size_test"],
                 cfg["max_tokens"], cfg["text_num_hidden_layers"], cfg["num_cross_layers"],
                 cfg.get("k_test", K_TEST), cfg.get("num_dec_layers", 6),
                 cfg.get("answer_max_tokens", ANSWER_LEN))
        want = ("cclm", 384, IGLUE_BATCH, IGLUE_EVAL_BATCH,
                IGLUE_LONG if task in ("wit", "xflickrco") else TEXT_LEN, 12, 6, K_TEST, 6,
                ANSWER_LEN)
        if sizes != want:
            fail(f"iglue {task}: the shipped config's sizes {sizes} changed (expected {want})")
    log(f"phase 15 data and configs: {part_done('15', 'data', t0):.1f} s")

    records = {}             # run name -> {"steps", "evals", "ranks", "import", "state"}
    batches = collections.defaultdict(list)
    orig = {"step": run_mod.make_train_step, "save": ckpt_lib.save_train_state,
            "load": ckpt_lib.load_converted, "to_device": run_mod.to_device,
            "restore": ckpt_lib.restore_train_state, "rank": XVLMForVQA.rank_answer,
            "retrieval": retrieval_mod.evaluate_retrieval,
            "predict": {c: c.predict for c in (XVLMForClassification, XVLMForNLVR, XVLMForVQA)}}
    evaluated = {"xvnli": XVLMForClassification, "marvl": XVLMForNLVR, "xgqa": XVLMForVQA}
    timed = functools.partial(timed_call, args, smi)
    counts, train_deltas, savers = [], [], []

    def launch(name: str, task: str, argv: list, save=None, restore=None,
               keep_state: bool = False):
        """One launcher run with its steps, eval calls, rank passes and
        import read; ``save`` / ``restore`` stand in for the train state's
        (default: nothing saved); with ``keep_state`` the trained
        parameters are kept (on the host) for the hold."""
        rec = records[name] = {"steps": [], "evals": [], "ranks": [], "import": {}}
        model_ref = []

        def make_step(model, optimizer, **kw):
            model_ref.append(model)
            rec["params"] = [n for n, _ in model.named_parameters()]
            return timed(orig["step"](model, optimizer, **kw), rec["steps"],
                         f"chip_smoke_iglue_{name}_step_profile.txt",
                         lambda i: bool(args.profile) and i == 1)

        def load(model, sd):
            rec["import"]["missing"], rec["import"]["unexpected"] = orig["load"](model, sd)
            return rec["import"]["missing"], rec["import"]["unexpected"]

        def to_device(batch, device):
            batches[name].append({k: hashlib.sha256(np.ascontiguousarray(v)).hexdigest()
                                  for k, v in batch.items()})
            return orig["to_device"](batch, device)

        def rank(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            t = time.perf_counter()
            start.record()
            result = orig["rank"](*a, **kw)
            end.record()
            end.synchronize()
            rec["ranks"].append({"ms": start.elapsed_time(end),
                                 "wall_ms": (time.perf_counter() - t) * 1e3,
                                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                 "rows": a[1].shape[0] * a[5]})
            return result

        profiled = lambda i: bool(args.profile) and i == 0   # noqa: E731
        evaluator = timed(orig["retrieval"] if task in ("wit", "xflickrco") else
                          orig["predict"][evaluated[task]], rec["evals"],
                          f"chip_smoke_iglue_{name}_eval_profile.txt", profiled)
        ckpt_lib.save_train_state = save or (
            lambda ckpt_dir, *a, **kw: os.path.join(ckpt_dir, ckpt_lib.TRAIN_STATE_FILE))
        ckpt_lib.restore_train_state = restore or orig["restore"]
        ckpt_lib.load_converted, run_mod.make_train_step = load, make_step
        run_mod.to_device, XVLMForVQA.rank_answer = to_device, rank
        if task in ("wit", "xflickrco"):
            retrieval_mod.evaluate_retrieval = evaluator
        else:
            evaluated[task].predict = evaluator
        reset_counts()
        t = time.perf_counter()
        try:
            rec["record"] = run_mod.main(argv)
        finally:
            ckpt_lib.save_train_state, ckpt_lib.restore_train_state = orig["save"], \
                orig["restore"]
            ckpt_lib.load_converted, run_mod.make_train_step = orig["load"], orig["step"]
            run_mod.to_device, XVLMForVQA.rank_answer = orig["to_device"], orig["rank"]
            retrieval_mod.evaluate_retrieval = orig["retrieval"]
            for c, fn in orig["predict"].items():
                c.predict = fn
        torch.cuda.synchronize()
        rec["seconds"] = part_done("15", "resume" if restore else "run", t)
        rec["counts"] = launch_counts()
        if keep_state:
            rec["state"] = {k: v.detach().to("cpu", copy=True)
                            for k, v in model_ref[0].state_dict().items()}
        del model_ref
        torch.cuda.empty_cache()
        return rec

    def check(name: str, task: str, n_steps: int, cfg: dict):
        """The run's import, record, each call's launches and the totals."""
        rec = records[name]
        fresh = {"xvnli": ("cls_head.",), "marvl": ("cls_head.",), "xgqa": ("text_decoder.",),
                 "wit": (), "xflickrco": ()}[task]
        # what the pretraining core has and the task model does not
        leftover = ("text_encoder.lm_head.", "bbox_head.")
        if task not in ("wit", "xflickrco"):
            leftover += ("vision_proj.", "text_proj.", "itm_head.")
        if task == "xgqa":
            leftover += ("temp",)
        missing, unexpected = rec["import"].get("missing"), rec["import"].get("unexpected", [])
        want_missing = sorted(k for k in rec.get("params", []) if k.startswith(fresh)) \
            if fresh else []
        log(f"phase 15 {name} import of phase 14's state: {len(missing or [])} missing (fresh: "
            f"{sorted({'.'.join(k.split('.')[:2]) for k in missing or []})}), unexpected "
            f"{sorted({'.'.join(k.split('.')[:2]) for k in unexpected})}")
        if missing != want_missing or not all(k.startswith(leftover) for k in unexpected) or \
                not unexpected:
            fail(f"iglue {name} import: missing {missing}, unexpected {unexpected}")
        record = rec["record"]
        loss = "loss_vqa" if task == "xgqa" else "loss_itm" if task in (
            "wit", "xflickrco") else "loss_cls"
        metric = "acc" if task == "xgqa" else "r_mean" if task in ("wit", "xflickrco") \
            else "accuracy"
        langs = tuple(cfg["test_file"]) if isinstance(cfg["test_file"], dict) else ()
        vals = [record.get(loss), record.get(f"eval_{metric}")] + \
            [record.get(f"eval_{lang}_{metric}") for lang in langs]
        if not all(isinstance(v, float) and math.isfinite(v) for v in vals) or \
                len(rec["steps"]) != n_steps:
            fail(f"iglue {name}: {len(rec['steps'])} steps, record {record}")
        n_evals = len(langs) or 1
        want = {True: iglue_launches(task, True), False: iglue_launches(task, False)}
        for kind, calls, train in (("step", rec["steps"], True), ("eval", rec["evals"], False)):
            for i, r in enumerate(calls):
                got = dict(r["launches"], plain=dict(r["delta"]["plain_shapes"]))
                if got != want[train]:
                    fail(f"iglue {name} {kind} {i}: launches {got}, expected {want[train]}")
        if len(rec["evals"]) != n_evals:
            fail(f"iglue {name}: {len(rec['evals'])} eval calls, expected {n_evals}")
        tiny, plain = collections.Counter(), collections.Counter()
        for train, n in ((True, len(rec["steps"])), (False, len(rec["evals"]))):
            for shape, k in want[train]["tiny_fwd"].items():
                tiny[shape] += k * n
            for shape, k in want[train]["plain"].items():
                plain[shape] += k * n
        c = rec["counts"]
        check_launcher_counts(
            f"iglue {name}", c, sum(want[t]["flash_fwd"] * n for t, n in (
                (True, len(rec["steps"])), (False, len(rec["evals"])))),
            12 * len(rec["steps"]),
            {"tiny_fwd": dict(tiny),
             "tiny_bwd": {k: n * len(rec["steps"]) for k, n in
                          want[True]["tiny_bwd"].items()}},
            n_plain=sum(plain.values()))
        if dict(c["plain_shapes"]) != dict(plain):
            fail(f"iglue {name}: plain attention by shape {dict(c['plain_shapes'])}, expected "
                 f"{dict(plain)}")
        if c["tiny_walks"]["tiny_attention_fwd"].get(TILED, 0) != \
                sum(n for (b, sq, skv), n in tiny.items() if skv == N_KEYS_384):
            fail(f"iglue {name}: the 40 x {N_KEYS_384} launches are not all key-tiled: "
                 f"{c['tiny_walks']}")
        images = 2 * IGLUE_BATCH if task == "marvl" else IGLUE_BATCH
        want_flash = {(images, N_IMG_384, N_IMG_384): 12 * len(rec["steps"])}
        eval_images = 2 * IGLUE_EVAL_BATCH if task == "marvl" else IGLUE_EVAL_BATCH
        want_flash[(eval_images, N_IMG_384, N_IMG_384)] = \
            want_flash.get((eval_images, N_IMG_384, N_IMG_384), 0) + \
            want[False]["flash_fwd"] * len(rec["evals"])
        if dict(c["flash_fwd_shapes"]) != want_flash:
            fail(f"iglue {name}: flash shapes {dict(c['flash_fwd_shapes'])}, expected "
                 f"{want_flash}")
        counts.append(c)
        train_deltas.extend(r["delta"] for r in rec["steps"])
        ms = lambda rs: [[round(r["ms"], 3), round(r["wall_ms"], 3)] for r in rs]  # noqa: E731
        log(f"phase 15 {name} ({IGLUE_CONFIGS[task]}): step ms at 384 px, B={IGLUE_BATCH} "
            f"(CUDA events, wall) {json.dumps(ms(rec['steps']))}, peak GiB "
            f"{[round(r['peak_gib'], 2) for r in rec['steps']]}; eval calls ms "
            f"{json.dumps(ms(rec['evals']))}, eval seconds "
            f"{sum(r['wall_ms'] for r in rec['evals']) / 1e3:.3f}, peak GiB "
            f"{[round(r['peak_gib'], 2) for r in rec['evals']]}; run {rec['seconds']:.1f} s; "
            f"{smi}; {json.dumps(record)}")

    def cfg_path(name, cfg):
        path = os.path.join(work, "iglue", f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f, ensure_ascii=False)
        return path

    def argv(task, name, cfg, *extra, out=None):
        return ["--task", task, "--config", cfg_path(name, cfg), "--output_dir",
                out or os.path.join(work, f"out_{name}"), "--checkpoint", plus["ckpt"],
                "--seed", str(args.seed), "--device", dev.type, *extra]

    def submit_hold(family: str, task: str):
        """The hold of 2 rows of ``task``'s train set with its trained state
        (saved to ``work``), deferred to the holds' worker."""
        th = time.perf_counter()
        train_ds, test_ds = create_dataset(task, cfgs[task], rng=random.Random(args.seed))
        answers = None
        if family == "vqa":
            batch = vqa_collate([train_ds[0], train_ds[1]], 4, rng=random.Random(args.seed))
            first = next(iter(test_ds.values()))
            answers = {"answer_ids": torch.from_numpy(first.answer_ids).long(),
                       "answer_atts": torch.from_numpy(first.answer_atts)}
        else:
            batch = collate([train_ds[0], train_ds[1]])
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        for k in ("text_ids", "labels", "question_ids", "answer_ids", "answer_index", "idx"):
            if k in batch:
                batch[k] = batch[k].long()
        state = records[task].pop("state")

        def save_and_defer():
            defer_hold(f"phase 15 {family} ({task}'s weights) card bf16 vs CPU fp32 (2 rows, "
                       f"dropout off{', negatives injected' if family == 'retrieval' else ''})",
                       iglue_hold, family, hold_state(state, f"iglue_{family}.pt"), cfgs[task],
                       batch, dev, answers)

        if HOLDS["pool"] is None:
            save_and_defer()
        else:    # the state's save beside the next run
            savers.append(threading.Thread(target=save_and_defer))
            savers[-1].start()
        part_done("15", "hold", th)

    for task, family in (("xvnli", "classification"), ("marvl", "nlvr"), ("wit", "retrieval"),
                         ("xflickrco", None)):
        launch(task, task, argv(task, task, cfgs[task], "--epoch", "1"),
               keep_state=family is not None)
        check(task, task, N_IGLUE_TRAIN // IGLUE_BATCH, cfgs[task])
        if family is not None:
            submit_hold(family, task)
    # XVNLI once more: --task classification (its dataset_type) under --fewshot
    few = dict(cfgs["xvnli"], train_file=[os.path.join(work, "iglue", "xvnli_{}_{}.jsonl")],
               test_file=os.path.join(work, "iglue", "xvnli_test_{}.jsonl"))
    launch("xvnli_fewshot", "xvnli", argv("classification", "xvnli_fewshot", few, "--epoch",
                                          "1", "--fewshot", XVNLI_FEWSHOT))
    with open(os.path.join(work, "out_xvnli_fewshot", "config.json")) as f:
        filled = json.load(f)
    lang, shots = XVNLI_FEWSHOT.split(",")
    if filled["train_file"] != [os.path.join(work, "iglue", f"xvnli_{lang}_{shots}.jsonl")] or \
            filled["test_file"] != os.path.join(work, "iglue", f"xvnli_test_{lang}.jsonl"):
        fail(f"iglue --fewshot {XVNLI_FEWSHOT}: filled {filled['train_file']}, "
             f"{filled['test_file']}")
    check("xvnli_fewshot", "xvnli", 1, few)

    # xGQA: 2 epochs of a step, the state of step 1 kept for --resume
    out, out_resumed = os.path.join(work, "out_xgqa"), os.path.join(work, "out_xgqa_resumed")

    def save(ckpt_dir, model, optimizer, step, data_state=None):
        """The state of step 1 straight into the resumed run's ``ckpt``;
        nothing else (the hold reads the trained model's parameters)."""
        if ckpt_dir == os.path.join(out, "ckpt") and step == XGQA_RESUME_STEP:
            return orig["save"](os.path.join(out_resumed, "ckpt"), model, optimizer, step,
                                data_state)
        return os.path.join(ckpt_dir, ckpt_lib.TRAIN_STATE_FILE)

    launch("xgqa", "xgqa", argv("xgqa", "xgqa", cfgs["xgqa"], "--epoch", "2"), save=save,
           keep_state=True)
    check("xgqa", "xgqa", 2, cfgs["xgqa"])
    submit_hold("vqa", "xgqa")
    for lang in IGLUE_LANGS:
        with open(os.path.join(out, f"vqa_result_{lang}.json")) as f:
            if len(json.load(f)) != IGLUE_EVAL_BATCH:
                fail(f"iglue xgqa: vqa_result_{lang}.json holds no answer for each question")
    ranks = records["xgqa"]["ranks"]
    capacity = torch.cuda.get_device_properties(dev).total_memory / 2**30 \
        if dev.type == "cuda" else float("inf")
    log(f"phase 15 xgqa rank pass (Q = {IGLUE_EVAL_BATCH}, k = {K_TEST}: "
        f"{IGLUE_EVAL_BATCH * K_TEST} rows in chunks of {XGQA_RANK_CHUNK} at {XLMR_VOCAB} "
        f"vocabulary rows; CUDA-event ms, wall ms, peak GiB of the card's {capacity:.1f}; {smi}): "
        + json.dumps([[round(r["ms"], 3), round(r["wall_ms"], 3), round(r["peak_gib"], 2)]
                      for r in ranks]))
    if len(ranks) != len(IGLUE_LANGS) or \
            not all(r["rows"] == IGLUE_EVAL_BATCH * K_TEST and r["peak_gib"] < capacity
                    for r in ranks):
        fail(f"iglue xgqa rank pass: {ranks}")

    saved = torch.load(os.path.join(out_resumed, "ckpt", ckpt_lib.TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=False)
    restored = {}

    def restore(ckpt_dir, model, optimizer):
        result = orig["restore"](ckpt_dir, model, optimizer)
        copy = lambda t: t.detach().to("cpu", copy=True)   # noqa: E731
        restored.update(params={n: copy(p) for n, p in model.named_parameters()},
                        mu=dict(zip(optimizer.names, map(copy, optimizer.mu))),
                        nu=dict(zip(optimizer.names, map(copy, optimizer.nu))),
                        count=optimizer.count)
        return result

    launch("xgqa_resumed", "xgqa", argv("xgqa", "xgqa_resumed", cfgs["xgqa"], "--epoch", "2",
                                        "--resume", out=out_resumed), restore=restore)
    same = bool(restored) and saved["step"] == XGQA_RESUME_STEP and \
        restored["count"] == saved["count"] and all(
            restored[part].keys() == saved[part].keys() and
            all(torch.equal(restored[part][k], saved[part][k]) for k in saved[part])
            for part in ("params", "mu", "nu"))
    same_batches = batches["xgqa_resumed"] == batches["xgqa"][XGQA_RESUME_STEP:]
    log(f"phase 15 xgqa --resume from step {saved['step']}: "
        f"{records['xgqa_resumed']['seconds']:.1f} s; restored state equal to the saved one bit "
        f"for bit: {same}; its {len(batches['xgqa_resumed'])} batch equal to the whole run's "
        f"step {XGQA_RESUME_STEP + 1} bit for bit: {same_batches} "
        f"({len(records['xgqa_resumed']['steps'])} step)")
    if not same or not same_batches:
        fail("iglue xgqa --resume: the restored state or the batch after it differs from the "
             "whole run's")
    check("xgqa_resumed", "xgqa", 1, cfgs["xgqa"])
    del saved, restored
    shutil.rmtree(out_resumed, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)

    for saver in savers:
        saver.join()
    records.clear()
    phase_seconds("15", t0)
    return split_counts({k: sum((collections.Counter(c[k]) for c in counts),
                                collections.Counter()) for k in LEDGER_PARTS}, train_deltas)


# ---- phases 16 and 17: X2VLM-large, remat and accumulation ----

LARGE_PRETRAIN_CONFIG = "configs/pretrain/x2vlm_large_4m.yaml"
LARGE_VQA_CONFIG = "configs/finetune/vqa2_large.yaml"
LARGE_STEPS = 2                      # phase 16: 2 pretraining steps, one epoch
N_LARGE_VQA_TRAIN = 2 * LARGE_VQA_BATCH   # phase 17: 2 steps in one epoch
# phase 16's remat hold: remat changes no forward operation, so the losses
# are equal bit for bit; the gradients differ by the card's backward alone
# (ROADMAP C: its atomics), while a dropout mask replayed wrong moves about
# a fifth of the dropped elements
REMAT_HOLD_COSINE, REMAT_HOLD_REL_L2 = 0.9999, 1e-3


def large_tok_dir(root: str, tok_dir: str) -> str:
    """Phase 7's vocab under a directory named for BERT-large: the factory
    takes the text preset from the ``text_encoder`` path, as the JAX one."""
    d = os.path.join(root, "bert-large-uncased")
    if not os.path.isdir(d):
        os.makedirs(d)
        shutil.copy(os.path.join(tok_dir, "vocab.txt"), d)
    return d


def set_remat(model, on: bool, policy=None) -> None:
    """Every tower and stack of ``model`` with remat ``on`` under ``policy``
    (their configs replaced; the parameters stay)."""
    from x2vlm_tpu_torch.models import BEiT2Config, BertConfig

    for m in model.modules():
        if isinstance(getattr(m, "config", None), (BEiT2Config, BertConfig)):
            m.config = dataclasses.replace(m.config, remat=on, remat_policy=policy)


def check_heads(tag: str, c: dict, heads: int, tiny_heads: int = None) -> None:
    """Every attention launch of ``c`` (a ``launch_counts`` or its delta) at
    ``heads`` heads; given ``tiny_heads``, the tiny ones (the text stacks')
    at that count instead (the flash ones are the vision tower's)."""
    tiny_heads = tiny_heads or heads
    other = {k: n for k, n in c["heads"].items() if n and not k.endswith(
        f"/{tiny_heads if k.startswith('tiny') else heads}")}
    if other or not any(c["heads"].values()):
        fail(f"{tag}: attention launches by kernel / heads {dict(c['heads'])}, expected flash "
             f"at {heads}, tiny at {tiny_heads}")


def large_stream_launches(stream: str) -> dict:
    """The tiny launches of one phase-16 stream call (forward and backward
    alike): the text pass over the clean and masked rows (12 layers), the
    ITM + MLM fusion pass over 4 x 64 rows (6); the region stream also the
    bbox pass over its 64 rows' full images."""
    B = LARGE_BATCH if stream == "image" else LARGE_REGION_ROWS
    out = {(2 * B, TEXT_LEN, TEXT_LEN): 12, (4 * B, TEXT_LEN, TEXT_LEN): 6,
           (4 * B, TEXT_LEN, 200): 6}
    if stream == "region":
        out.update({(B, TEXT_LEN, TEXT_LEN): 6, (B, TEXT_LEN, 200): 6})
    return out


def grad_families(model, fusion_layer: int) -> dict:
    """The parameters of each gradient family of the remat hold: the vision
    tower, a text layer, a fusion layer, the heads (ITM, projections, the
    MLM transform)."""
    p = "base.text_encoder.bert.encoder.layer."
    fams = {"vision": "base.vision_encoder.", "text layer": f"{p}0.",
            "fusion layer": f"{p}{fusion_layer}.",
            "heads": ("base.itm_head.", "base.vision_proj.", "base.text_proj.",
                      "base.text_encoder.cls.")}
    return {f: [(n, t) for n, t in model.named_parameters() if n.startswith(pre)]
            for f, pre in fams.items()}


def remat_hold(final: dict, mcfg, seed: int, dev) -> None:
    """Phase 16's remat hold on the card: the run's weights on 2 images with
    the config's dropouts on, one step's loss and gradients without remat,
    under ``dots`` and under full remat, each from the same generator seeds
    (the hard negatives', the dropouts'): the forward losses and the dropout
    generator's state after the step equal bit for bit, each gradient
    family within ``REMAT_HOLD_COSINE`` / ``REMAT_HOLD_REL_L2`` of the plain
    step's, every block rematerialised."""
    from x2vlm_tpu_torch.ops.remat import rematerialised

    model = XVLMForPretrain(mcfg, dtype=torch.bfloat16, device=dev, seed=None)
    model.load_state_dict(final)
    model.train()
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    batch = train_batch(gen, dev, mcfg, 2)
    fams = grad_families(model, mcfg.text.fusion_layer)
    runs = {}
    for label, on, policy in (("plain", False, None), ("dots", True, "dots"),
                              ("full", True, None)):
        set_remat(model, on, policy)
        model.zero_grad(set_to_none=True)
        rematerialised.calls.clear()
        itm_gen = torch.Generator(device=dev).manual_seed(seed + 17)
        drop_gen = torch.Generator(device=dev).manual_seed(seed + 18)
        losses = model(batch, itm_gen, drop_gen)
        sum(losses.values()).backward()
        runs[label] = {"losses": {k: v.item() for k, v in losses.items()},
                       "state": drop_gen.get_state(), "calls": dict(rematerialised.calls),
                       "grads": {f: [t.grad.detach().clone() for _, t in ps]
                                 for f, ps in fams.items()}}
    set_remat(model, False)
    plain = runs["plain"]
    want_calls = {"BEiT2Block": mcfg.vision.depth, "BertLayer": mcfg.text.num_layers}
    readings = {}
    for label in ("dots", "full"):
        r = runs[label]
        fam = {}
        for f, grads in r["grads"].items():
            dot = sum((a.double() * b.double()).sum() for a, b in zip(grads, plain["grads"][f]))
            na = sum((a.double() ** 2).sum() for a in grads).sqrt()
            nb = sum((b.double() ** 2).sum() for b in plain["grads"][f]).sqrt()
            diff = sum(((a.double() - b.double()) ** 2).sum()
                       for a, b in zip(grads, plain["grads"][f])).sqrt()
            fam[f] = {"cosine": (dot / (na * nb)).item(), "rel_l2": (diff / nb).item()}
        readings[label] = fam
        if r["losses"] != plain["losses"]:
            fail(f"remat hold {label}: forward losses {r['losses']} differ from the plain "
                 f"step's {plain['losses']}")
        if not torch.equal(r["state"], plain["state"]):
            fail(f"remat hold {label}: the dropout generator ends elsewhere than the plain "
                 f"step's")
        if r["calls"] != want_calls:
            fail(f"remat hold {label}: rematerialised blocks {r['calls']}, expected "
                 f"{want_calls}")
        for f, x in fam.items():
            if not (x["cosine"] >= REMAT_HOLD_COSINE and x["rel_l2"] <= REMAT_HOLD_REL_L2):
                fail(f"remat hold {label} {f}: cosine {x['cosine']:.6f}, relative L2 "
                     f"{x['rel_l2']:.2e} to the plain step's gradient (limits "
                     f"{REMAT_HOLD_COSINE}, {REMAT_HOLD_REL_L2})")
    log(f"phase 16 remat hold (2 images, dropouts on, the same generator seeds): losses "
        f"{json.dumps(plain['losses'])} in all three, equal bit for bit: "
        f"{all(runs[k]['losses'] == plain['losses'] for k in ('dots', 'full'))}; gradient "
        f"families against the plain step's {json.dumps(readings)}")
    del model, runs
    torch.cuda.empty_cache()


def large_hold_batches(mcfg, text_len: int = TEXT_LEN):
    """2 images with ``text_len``-token texts and 2 region rows over 2
    images, 4 masked positions a row, the last row padded."""
    g = torch.Generator().manual_seed(16)
    res, side = mcfg.vision.image_res, mcfg.vision.image_res // mcfg.vision.patch_size

    def texts(pad_from):
        pad_from -= TEXT_LEN - text_len
        ids = torch.randint(1000, VOCAB_SIZE, (2, text_len), generator=g)
        ids[:, 0] = 101
        atts = torch.ones(2, text_len, dtype=torch.int32)
        atts[1, pad_from:] = 0
        ids = ids * atts
        pos = torch.tensor([[3, 7, 9, 15], [2, 5, 20, min(30, pad_from - 2)]])
        masked = ids.clone()
        masked[torch.arange(2)[:, None], pos] = 103
        return {"text_ids": ids, "text_atts": atts, "text_ids_masked": masked,
                "masked_pos": pos, "masked_ids": torch.gather(ids, 1, pos)}

    image = dict(texts(33), image=torch.randint(0, 256, (2, res, res, 3), generator=g,
                                                dtype=torch.uint8))
    grid = torch.zeros(2, side, side)
    grid[0, 4:10, 3:8] = 1
    grid[1, 2:7, 6:10] = 1
    region = dict(texts(36), image=torch.randint(0, 256, (2, res, res, 3), generator=g,
                                                 dtype=torch.uint8),
                  image_atts=torch.cat([torch.ones(2, 1), grid.view(2, -1)], 1),
                  idx_to_group_img=torch.tensor([0, 1]), target_bbox=torch.zeros(2, 4),
                  is_image=torch.zeros(2))
    return image, region


def large_cosine_params(mcfg):
    """Gradients held to the CPU path: the vision tower (K2/K3, K4), a text
    layer (K6 at 40 x 40), a fusion layer's self and cross attention (K6 at
    40 x 200), the ITM and bbox heads."""
    p = "base.text_encoder.bert.encoder.layer."
    f = f"{p}{mcfg.text.fusion_layer}"
    return ("base.vision_encoder.blocks.0.attn.qkv.weight",
            "base.vision_encoder.blocks.0.attn.relative_position_bias_table",
            f"{p}0.attention.self.query.weight", f"{f}.attention.self.query.weight",
            f"{f}.crossattention.self.key.weight", "base.itm_head.0.weight",
            "base.bbox_head.0.weight")


ITM_TERM_COSINE = 0.99                # the terms' limit: the gradient cosines' 0.99
# the summed gradient's distance from the CPU's, over the larger of the
# terms' root-sum-square and the CPU sum's norm: card runs at five seeds
# read 0.0132-0.0355 (PERF.md); a zeroed card gradient reads 0.0975 at
# --seed 1, where the rows' p - y cancel (a smaller fault in the product
# is the applied hold's)
ITM_SUM_LIMIT = 0.06
# the applied gradient against the pass's own terms summed: each call's sum
# is rounded once to the compute dtype (bf16: 2^-9 of each element), 4x that
ITM_APPLIED_LIMIT = 2.0 ** -7
ITM_HEAD_WEIGHT = "base.itm_head.0.weight"


@contextlib.contextmanager
def itm_head_terms(model, calls: list):
    """Record the terms of the ITM head's first weight gradient, one entry
    of ``calls`` an ITM head call: its input ``x`` (the fused CLS features,
    a row a pair, in the compute dtype the product reads), the gradient
    ``delta`` of the loss at its first dense's output and the gradient
    ``dlogits`` at its logits, (p - y) / rows. The weight's gradient is the
    sum over rows of ``delta_r`` x ``x_r`` (outer products), which
    ``itm_term_faults`` holds term by term."""
    from x2vlm_tpu_torch.models import xvlm as xvlm_mod

    head = model.base.itm_head
    orig = xvlm_mod.dense

    def dense(x, w, b, dtype):
        out = orig(x, w, b, dtype)
        if w is head[0].weight and torch.is_grad_enabled():
            rec = {"x": x.detach().to(dtype).double().cpu()}
            out.register_hook(lambda g: rec.__setitem__("delta", g.detach().double().cpu()))
            calls.append(rec)
        return out

    def logits_hook(module, inputs, out):
        if out.requires_grad:
            rec = calls[-1]
            out.register_hook(lambda g: rec.__setitem__("dlogits",
                                                        g.detach().double().cpu()))

    handle = head.register_forward_hook(logits_hook)
    xvlm_mod.dense = dense
    try:
        yield calls
    finally:
        xvlm_mod.dense = orig
        handle.remove()


def itm_term_faults(cpu: list, card: list, cpu_grad: torch.Tensor, card_grad: torch.Tensor,
                    limit: float = ITM_TERM_COSINE) -> tuple:
    """Hold the ITM head's first weight gradient term by term, card (or any
    pass under test) against CPU fp32: every row's fused CLS features
    (cosine), each call's p - y over its rows (cosine of the vectors), every
    row's gradient before the sum (the outer product delta_r x_r, whose
    cosine is cos(delta) cos(x)), each at ``limit``. Each pass's terms must
    add up to the gradient it applied: the CPU's within 1e-4 of their
    scale, the card's within ``ITM_APPLIED_LIMIT`` of its calls' sums
    (the product rounds each call's sum once). The summed gradient is a
    near-cancelling sum of the terms (the rows' p - y nearly cancel at
    trained weights), so its cosine reads the compute dtype's floor; its
    distance from the CPU's is held to ``ITM_SUM_LIMIT`` of the larger of
    the terms' root-sum-square and the CPU sum's norm. Returns (readings,
    faults)."""
    faults = []
    if len(cpu) != len(card) or not cpu or any(
            set(c) != {"x", "delta", "dlogits"} for c in cpu + card):
        return {}, [f"ITM head calls recorded: {len(cpu)} on the CPU, {len(card)} on the card "
                    f"(each with x, delta and dlogits)"]
    cos = lambda a, b: F.cosine_similarity(a, b, dim=-1)
    x_cos, d_cos, row_cos, py_cos = [], [], [], []
    for i, (c, g) in enumerate(zip(cpu, card)):
        if c["x"].shape != g["x"].shape or c["delta"].shape != g["delta"].shape:
            faults.append(f"ITM call {i}: shapes {tuple(g['x'].shape)} / "
                          f"{tuple(g['delta'].shape)}, CPU {tuple(c['x'].shape)} / "
                          f"{tuple(c['delta'].shape)}")
            continue
        xc, dc = cos(g["x"], c["x"]), cos(g["delta"], c["delta"])
        x_cos += xc.tolist()
        d_cos += dc.tolist()
        row_cos += (xc * dc).tolist()
        # p - y of the positive class, a row each; the two columns are opposites
        py_cos.append(cos(g["dlogits"][:, 1], c["dlogits"][:, 1]).item())
    if faults:
        return {}, faults
    for name, vals in (("fused CLS features", x_cos), ("p - y", py_cos),
                       ("per-row gradient", row_cos)):
        low = [round(v, 5) for v in vals if not v >= limit]
        if low:
            faults.append(f"ITM head {name}: cosines {low} below {limit} "
                          f"(of {len(vals)})")

    def call_sums(calls):
        return [torch.einsum("ro,ri->oi", c["delta"], c["x"]).reshape(-1) for c in calls]

    cpu_calls, card_calls = call_sums(cpu), call_sums(card)
    scale = math.sqrt(sum(float(torch.einsum("ro,ri->r", c["delta"] ** 2, c["x"] ** 2).sum())
                          for c in cpu))
    cpu_sum, card_sum = sum(cpu_calls), sum(card_calls)
    cpu_grad, card_grad = cpu_grad.double().reshape(-1), card_grad.double().reshape(-1)
    own = float((cpu_sum - cpu_grad).norm()) / scale
    applied = float((card_sum - card_grad).norm()) / sum(float(t.norm()) for t in card_calls)
    sum_scale = max(scale, float(cpu_sum.norm()))
    dist = float((card_grad - cpu_grad).norm()) / sum_scale
    summed_cos = F.cosine_similarity(card_grad, cpu_grad, dim=0).item()
    if not own <= 1e-4:
        faults.append(f"ITM head: the CPU's terms add to its gradient within {own:.2e} of "
                      f"their scale (at most 1e-4)")
    if not applied <= ITM_APPLIED_LIMIT:
        faults.append(f"ITM head: the card's applied gradient is {applied:.5f} of its calls' "
                      f"sums from its own terms (at most {ITM_APPLIED_LIMIT:.5f})")
    if not dist <= ITM_SUM_LIMIT:
        faults.append(f"ITM head summed gradient: {dist:.5f} of the larger of the terms' scale "
                      f"and the sum's from the CPU's (at most {ITM_SUM_LIMIT})")
    readings = {"rows": len(x_cos), "min_feature_cos": min(x_cos), "min_p_y_cos": min(py_cos),
                "min_row_grad_cos": min(row_cos), "applied_over_call_sums": applied,
                "summed_dist_over_scale": dist, "summed_cos": summed_cos,
                "summed_norm_over_terms": float(cpu_sum.norm()) / scale}
    return readings, faults


def large_pretrain_hold(final, mcfg, dev, text_len: int = TEXT_LEN,
                        noisy: bool = False, itm_terms: bool = False) -> tuple:
    """Phase 16's weights ``final`` (or the state saved at that path) on 2
    images and 2 region rows, dropout off, the negatives injected: the card
    in bf16 against the port's CPU fp32 path, each loss (ITC, ITM, MLM of
    both streams, bbox L1 and GIoU) within 0.05 + 2%, gradient cosines of
    ``large_cosine_params`` >= 0.99, each bf16 ``text_len`` x 200 call into
    K5 and K6 (the image pass's and the region passes' fusion
    cross-attention) within ``FUSION_CALL_RATIO`` of the bf16 rule's bound.
    The box targets are ``off_kink_targets`` of the CPU path's boxes. With
    ``noisy`` (phases 18, 19: an aux stream beside the image stream) the
    image batch also runs as a noisy batch: no matching loss, the MLM
    through the whole stack. Phases 18 and 19 call it with their own
    weights and text length. With ``itm_terms`` (phase 19, at its run's
    weights) the ITM head's first weight is held term by term
    (``itm_term_faults``): there the rows' p - y nearly cancel, and its
    summed gradient's cosine reads the bf16 floor, not the path."""
    final = params_of(final)
    image, region = large_hold_batches(mcfg, text_len)
    neg = (torch.tensor([1, 0]), torch.tensor([1, 0]))
    names = large_cosine_params(mcfg)
    n_fusion = mcfg.text.num_layers - mcfg.text.fusion_layer
    fwd_ratios, bwd_ratios, losses, grads = [], [], {}, {}
    itm_calls = {}
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        model = XVLMForPretrain(mcfg, dtype=dtype, device=device, seed=None)
        model.load_state_dict(final)
        terms = itm_head_terms(model, itm_calls.setdefault(tag, [])) if itm_terms \
            else contextlib.nullcontext()
        to = lambda b: {k: v.to(device) for k, v in b.items()}
        negs = tuple(t.to(device) for t in neg)
        if tag == "cpu":
            region["target_bbox"] = off_kink_targets(cpu_boxes(
                model, model.base.bbox_head,
                lambda: model(to(region), neg_idx=negs, ret_bbox_loss=True)))
        with held_tiny_calls(200, fwd_ratios), held_tiny_bwd_calls(200, bwd_ratios), terms:
            out = {f"image_{k}": v for k, v in model(to(image), neg_idx=negs).items()}
            out.update({f"region_{k}": v for k, v in model(
                to(region), neg_idx=negs, ret_bbox_loss=True).items()})
            if noisy:
                out.update({f"noisy_{k}": v for k, v in model(
                    to(image), ret_match_loss=False).items()})
            sum(out.values()).backward()
        losses[tag] = {k: v.item() for k, v in out.items()}
        params = dict(model.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1) for k in names}
        del model, out, params
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in names}
    r = {"losses": losses, "cosine": cos, "fwd_ratios": [round(x, 3) for x in fwd_ratios],
         "bwd_ratios": [round(x, 3) for x in bwd_ratios]}
    faults = []
    if itm_terms:
        r["itm_terms"], term_faults = itm_term_faults(
            itm_calls["cpu"], itm_calls["card"], grads["cpu"][ITM_HEAD_WEIGHT],
            grads["card"][ITM_HEAD_WEIGHT])
        faults += term_faults
    want = {"image_loss_itc", "image_loss_itm", "image_loss_mlm", "region_loss_itc",
            "region_loss_itm", "region_loss_mlm", "region_loss_bbox", "region_loss_giou"}
    if noisy:
        want |= {"noisy_loss_itc", "noisy_loss_itm", "noisy_loss_mlm"}
    if set(losses["card"]) != want or (noisy and losses["card"]["noisy_loss_itm"] != 0.0):
        faults.append(f"losses {losses['card']}, expected {sorted(want)} (a noisy ITM of 0)")
    for k, ref in losses["cpu"].items():
        if not abs(losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            faults.append(f"{k}: card {losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    for k, c in cos.items():
        if not c >= 0.99 and not (itm_terms and k == ITM_HEAD_WEIGHT):
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    # the image's ITM + MLM fusion pass, the region's and its bbox pass (and
    # the noisy batch's MLM pass)
    n_calls = (4 if noisy else 3) * n_fusion
    for kind, ratios in (("forward", fwd_ratios), ("backward", bwd_ratios)):
        if len(ratios) != n_calls or not all(x <= FUSION_CALL_RATIO for x in ratios):
            faults.append(f"the {text_len} x 200 {kind} calls: {len(ratios)} held (expected "
                          f"{n_calls}), errors over the bf16 rule's bound "
                          f"{[round(x, 3) for x in ratios]} (at most {FUSION_CALL_RATIO})")
    return r, faults


def large_pretrain_phase(args, root: str, tok_dir: str, work: str, dev, smi: str = ""):
    """Phase 16: ``x2vlm_tpu_torch.run --task pretrain`` in process on the
    shipped ``configs/pretrain/x2vlm_large_4m.yaml`` (X2VLM-large from
    ``--seed``) at its own sizes, on phase 7's image and region lines: 2
    steps, each stream call timed and its launches read; the state saved
    once, at the end, in memory (``kept_params_save``; no resume reads it),
    and exported as a ``.th``. Then ``remat_hold`` on the card
    and ``large_pretrain_hold`` deferred. Returns the launches, the large
    tokenizer directory and the path of the run's weights as a
    reference-named ``.th`` (in ``work``)."""
    from x2vlm_tpu_torch import run as run_mod

    t0 = time.perf_counter()
    large_tok = large_tok_dir(root, tok_dir)
    shipped = shipped_config(LARGE_PRETRAIN_CONFIG)
    cfg = dict(shipped, train_file=[os.path.join(root, "images.jsonl")],
               train_file_regions=[os.path.join(root, "regions.jsonl")], text_encoder=large_tok,
               train_dataset_size=LARGE_STEPS * LARGE_BATCH)
    sizes = (cfg["images"]["batch_size"], cfg["regions"]["batch_size"],
             cfg["regions"]["max_images"], cfg["image_res"], cfg.get("remat", False))
    if sizes != (LARGE_BATCH, LARGE_REGION_ROWS, LARGE_REGION_IMAGES, 224, False):
        fail(f"large pretrain launcher: the shipped config's sizes {sizes} changed")
    mcfg = xvlm_config_from_yaml(cfg)
    cfg_path = os.path.join(root, "large_pretrain.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(work, "out_large_pretrain")
    argv = ["--task", "pretrain", "--config", cfg_path, "--output_dir", out, "--seed",
            str(args.seed), "--device", dev.type, "--epoch", "1"]
    log(f"phase 16 data and config: {part_done('16', 'data', t0):.1f} s")

    t1 = time.perf_counter()
    saves, kept = [], {}
    save = ckpt_lib.save_train_state
    reset_counts()
    ckpt_lib.save_train_state = kept_params_save(kept, saves)
    try:
        with StreamTimer({("image", LARGE_STEPS - 1), ("region", LARGE_STEPS - 1)}
                         if args.profile else None,
                         (args, smi, "chip_smoke_large_{stream}_profile.txt")) as timer:
            record = run_mod.main(argv)
        check_data_plane("phase 16", record)
    finally:
        ckpt_lib.save_train_state = save
    torch.cuda.synchronize()
    counts = launch_counts()
    PHASE_PARTS["16"]["save"] += sum(saves)
    PHASE_PARTS["16"]["run"] += time.perf_counter() - t1 - sum(saves)
    log(f"phase 16 run ({LARGE_STEPS} steps): {time.perf_counter() - t1:.1f} s, the state "
        f"saves {[round(s, 1) for s in saves]} s; {json.dumps(record)}")
    want_losses = [f"{s}_loss_{k}" for s in ("image", "region") for k in ("itc", "itm", "mlm")] + \
        ["region_loss_bbox", "region_loss_giou"]
    if not all(isinstance(record.get(k), float) and math.isfinite(record[k])
               for k in want_losses) or record.get("broken", -1) != 0 or \
            record.get("pretrain_steps") != [0, LARGE_STEPS] or len(saves) != 1 or \
            kept.get("step") != LARGE_STEPS:
        fail(f"large pretrain launcher: record {record}, {len(saves)} saves")
    n = LARGE_STEPS
    want_tiny = collections.Counter()
    for stream in ("image", "region"):
        want_tiny.update({k: v * n for k, v in large_stream_launches(stream).items()})
    check_launcher_counts("large pretrain launcher", counts, 48 * n, 48 * n,
                          {"tiny_fwd": dict(want_tiny), "tiny_bwd": dict(want_tiny)})
    check_heads("large pretrain launcher", counts, LARGE_HEADS)
    for stream, B in (("image", LARGE_BATCH), ("region", LARGE_REGION_IMAGES)):
        calls = timer.calls[stream]
        if len(calls) != n:
            fail(f"large pretrain launcher: {len(calls)} {stream}-stream calls, expected {n}")
        want = large_stream_launches(stream)
        for i, c in enumerate(calls):
            tag = f"large pretrain launcher {stream} call {i}"
            check_launcher_counts(tag, c["launches"], 24, 24,
                                  {"tiny_fwd": want, "tiny_bwd": want})
            if dict(c["launches"]["flash_fwd_shapes"]) != {(B, N_IMG, N_IMG): 24}:
                fail(f"{tag}: flash shapes {dict(c['launches']['flash_fwd_shapes'])}")
    log(f"phase 16 by stream (CUDA-event ms and wall ms of each call, median; peak GiB; "
        f"{smi}): {json.dumps(timer.summary())}")

    t2 = time.perf_counter()
    final = kept.pop("params")
    th_path = os.path.join(work, "x2vlm_large_phase16.th")
    torch.save({"model": {k[len("base."):]: v for k, v in final.items()}}, th_path)
    hold_path = hold_state(final, "large_pretrain.pt")
    part_done("16", "export", t2)
    t3 = time.perf_counter()
    remat_hold(final, mcfg, args.seed, dev)
    part_done("16", "remat hold", t3)
    defer_hold("phase 16 card bf16 vs CPU fp32 (2 images, 2 region rows, dropout off)",
               large_pretrain_hold, hold_path, mcfg, dev)
    del final
    phase_seconds("16", t0)
    return counts, large_tok, th_path


def large_vqa_launches(train: bool) -> dict:
    """The attention launches of one phase-17 train step (16 questions in 2
    microbatches of 8, ``remat: dots``) or eval call (32 questions, no
    remat). A microbatch runs the vision pass (24 flash at S=2305), tiny
    at 8 x 40 x 40 (12 text layers, 6 fusion self-attentions), 8 x 40 x
    2312 (6 fusion cross-attentions, key-tiled) and 32 x 10 x 40 (the 6
    decoder layers' cross-attention over the step's 32 answer rows), and
    the decoder's 6 causal self-attentions on the plain core; each
    rematerialised layer's forward kernels launch twice (its forward and
    its recompute), its backward kernels once: a step is 2 x 2 x 24 flash
    forwards, 2 x 24 of each backward kernel, tiny forwards 2 x 2 x (18, 6,
    6), backwards 2 x (18, 6, 6), 2 x 2 x 6 plain calls. An eval call: 24
    flash, tiny 18 at 32 x 40 x 40, 6 at 32 x 40 x 2312, 6 at 32 x 1 x 40
    and 6 at 4096 x 10 x 40, 12 plain."""
    if not train:
        tiny = {(VQA_EVAL_BATCH, TEXT_LEN, TEXT_LEN): 18,
                (VQA_EVAL_BATCH, TEXT_LEN, N_KEYS_768): 6, (VQA_EVAL_BATCH, 1, TEXT_LEN): 6,
                (VQA_RANK_ROWS, ANSWER_LEN, TEXT_LEN): 6}
        return {"flash_fwd": 24, "flash_bwd": 0, "tiny_fwd": tiny, "tiny_bwd": {}, "plain": 12}
    a = LARGE_VQA_ACCUM
    per_mb = {(LARGE_VQA_MB, TEXT_LEN, TEXT_LEN): 18, (LARGE_VQA_MB, TEXT_LEN, N_KEYS_768): 6,
              (LARGE_VQA_ANSWERS, ANSWER_LEN, TEXT_LEN): 6}
    return {"flash_fwd": 2 * a * 24, "flash_bwd": a * 24,
            "tiny_fwd": {k: 2 * a * v for k, v in per_mb.items()},
            "tiny_bwd": {k: a * v for k, v in per_mb.items()}, "plain": 2 * a * 6}


def large_vqa_batch(cfg: dict, n: int, seed: int) -> dict:
    """``n`` train questions of ``cfg``'s data as the launcher collates them
    (``2 n`` answer rows), as CPU tensors."""
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.data.finetune import vqa_collate

    train_ds, _ = create_dataset("vqa", cfg, rng=random.Random(seed))
    batch = vqa_collate([train_ds[i] for i in range(n)], 2 * n, rng=random.Random(seed))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("question_ids", "answer_ids", "answer_index"):
        batch[k] = batch[k].long()
    return batch


def split_hold(model, batch: dict, dev, names) -> dict:
    """On the card, dropout off: the step's ``loss_vqa`` and gradients of
    ``names`` over ``batch`` split by question into ``LARGE_VQA_ACCUM``
    microbatches (each weighted 1 / accum, as ``make_train_step``) and
    unsplit."""
    from x2vlm_tpu_torch.train.trainer import split_batch

    b = {k: v.to(dev) for k, v in batch.items()}
    out = {}
    for label, parts in (("split", split_batch(b, LARGE_VQA_ACCUM)), ("unsplit", [b])):
        model.zero_grad(set_to_none=True)
        loss = 0.0
        for mb in parts:
            part = model(mb)["loss_vqa"] / len(parts)
            part.backward()
            loss += part.item()
        params = dict(model.named_parameters())
        out[label] = (loss, {k: params[k].grad.detach().double().reshape(-1) for k in names})
        torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    cos = {k: F.cosine_similarity(out["split"][1][k], out["unsplit"][1][k], dim=0).item()
           for k in names}
    return {"loss_vqa": {k: v[0] for k, v in out.items()}, "cosine": cos}


def remat_step_times(model, cfg: dict, batch: dict, dev, policies) -> dict:
    """One train step of ``model`` (AdamW with the launcher's groups,
    ``accumulate_steps`` 2, the config's dropouts on) on ``batch`` under
    each of ``policies`` ("none": no remat): the CUDA-event ms of the
    second of two steps and the peak device memory."""
    from x2vlm_tpu_torch import run as run_mod

    opt = run_mod.make_optimizer(cfg, model, 100, model.config.text.fusion_layer)
    step = make_train_step(model, opt, accum_steps=LARGE_VQA_ACCUM)
    b = {k: v.to(dev) for k, v in batch.items()}
    gens = (torch.Generator(device=dev).manual_seed(1), torch.Generator(device=dev).manual_seed(2))
    out = {}
    for policy in policies:
        set_remat(model, policy != "none", None if policy in ("none", "full") else policy)
        step(b, *gens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(b, *gens)
        end.record()
        end.synchronize()
        out[policy] = {"ms": start.elapsed_time(end),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "loss_vqa": m["loss_vqa"].item()}
        if not math.isfinite(out[policy]["loss_vqa"]):
            fail(f"remat step under {policy}: loss_vqa {out[policy]['loss_vqa']}")
    set_remat(model, True, "dots")
    del opt, step
    torch.cuda.empty_cache()
    return out


# the remat policies phase 17 times a step under ("none": no remat)
LARGE_STEP_POLICIES = ("dots", "full", "none")


def large_vqa_phase(args, root: str, th_path: str, large_tok: str, words, image_root: str,
                    work: str, dev, smi: str = "") -> dict:
    """Phase 17: ``x2vlm_tpu_torch.run --task vqa`` in process on the shipped
    ``configs/finetune/vqa2_large.yaml`` at its own sizes (768 px, 16
    questions a step in 2 microbatches, ``remat: dots``,
    ``large_lr_for_dec``; 32 questions an eval call, k_test 128) from phase
    16's ``.th`` (24 tables interpolated 14 -> 48, the decoder fresh), on
    32 train and 32 test questions written over phase 8's PNGs: one epoch
    of 2 steps and its eval, each step and eval call timed and its launches
    read (``large_vqa_launches``); the state saved in memory
    (``kept_params_save``). No ``--resume``: the launcher's resume is the code phases 7 and
    10 hold bit for bit, and one resume of this model loads an ~11 GB
    state. Then on the card, from the run's weights: the split step against
    the unsplit one (``split_hold``, dropout off) and a step's ms and peak
    memory under each of ``LARGE_STEP_POLICIES``; and ``vqa_hold`` on 2
    questions (training mode under ``dots``) deferred. Returns the
    launches split into the steps' and the eval's."""
    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.models import XVLMForVQA
    from x2vlm_tpu_torch.tasks import vqa as vqa_mod

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 17)
    train, test, answers = write_vqa_corpus(root, rng, words, len(os.listdir(image_root)),
                                            N_LARGE_VQA_TRAIN, VQA_EVAL_BATCH, "vqa_large")
    shipped = shipped_config(LARGE_VQA_CONFIG)
    cfg = dict(shipped, vqa_root=image_root, text_encoder=large_tok, train_file=[train],
               test_file=[test], answer_list=answers, start_eval=0)
    sizes = (cfg["batch_size"], cfg.get("answers_per_batch", 2 * cfg["batch_size"]),
             cfg.get("answer_max_tokens", ANSWER_LEN), cfg["accumulate_steps"], cfg["remat"],
             cfg["remat_policy"], cfg["large_lr_for_dec"], cfg["batch_size_test"],
             cfg["k_test"], cfg["image_res"], cfg["max_tokens"])
    if sizes != (LARGE_VQA_BATCH, LARGE_VQA_ANSWERS, ANSWER_LEN, LARGE_VQA_ACCUM, True, "dots",
                 True, VQA_EVAL_BATCH, K_TEST, 768, TEXT_LEN):
        fail(f"large vqa launcher: the shipped config's sizes {sizes} changed")
    mcfg = xvlm_config_from_yaml(cfg)
    cfg_path = os.path.join(root, "vqa_large.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(work, "out_vqa_large")
    log(f"phase 17 data and config: {part_done('17', 'data', t0):.1f} s")

    imported, steps, evals, saves, kept = {}, [], [], [], {}
    orig = {"load": ckpt_lib.load_reference_checkpoint, "save": ckpt_lib.save_train_state,
            "step": run_mod.make_train_step, "predict": XVLMForVQA.predict,
            "optimizer": run_mod.make_optimizer}
    timed = functools.partial(timed_call, args, smi)
    table_key = "vision_encoder.blocks.0.attn.relative_position_bias_table"

    def load(model, path):
        imported["missing"], imported["unexpected"] = orig["load"](model, path)
        imported["decoder"] = sorted(n for n, _ in model.named_parameters()
                                     if n.startswith("text_decoder."))
        src = torch.load(path, map_location="cpu", weights_only=False, mmap=True)["model"]
        got = model.state_dict()
        imported["rel_pos"] = []
        for i in range(mcfg.vision.depth):
            key = table_key.replace(".0.", f".{i}.")
            t = src[key].float().numpy()
            want = ckpt_lib.interp_rel_pos_table(t, 14, 48)
            imported["rel_pos"].append([list(t.shape), list(got[key].shape),
                                        bool(np.array_equal(got[key].cpu().numpy(), want))])
        return imported["missing"], imported["unexpected"]

    def make_optimizer(cfg_, model, *a, **kw):
        opt = orig["optimizer"](cfg_, model, *a, **kw)
        at_mult = {opt.names[i] for (_, scale), idx in opt.groups if scale == 2.0 for i in idx}
        imported["decoder_at_lr_mult"] = {n for n in opt.names
                                          if n.startswith("text_decoder.")} <= at_mult
        return opt

    def make_step(model, optimizer, **kw):
        imported["accum_steps"] = kw.get("accum_steps")
        return timed(orig["step"](model, optimizer, **kw), steps,
                     "chip_smoke_large_vqa_step_profile.txt",
                     lambda i: args.profile and i == 1)

    def patch(on: bool):
        ckpt_lib.load_reference_checkpoint = load if on else orig["load"]
        ckpt_lib.save_train_state = kept_params_save(kept, saves) if on else orig["save"]
        run_mod.make_train_step = make_step if on else orig["step"]
        run_mod.make_optimizer = make_optimizer if on else orig["optimizer"]
        XVLMForVQA.predict = timed(orig["predict"], evals,
                                   "chip_smoke_large_vqa_eval_profile.txt",
                                   lambda i: bool(args.profile) and i == 0) \
            if on else orig["predict"]

    argv = ["--task", "vqa", "--config", cfg_path, "--checkpoint", th_path, "--epoch", "1",
            "--seed", str(args.seed), "--device", dev.type, "--output_dir", out]
    t1 = time.perf_counter()
    reset_counts()
    patch(True)
    try:
        record = run_mod.main(argv)
    finally:
        patch(False)
    torch.cuda.synchronize()
    counts = launch_counts()
    PHASE_PARTS["17"]["save"] += sum(saves)
    PHASE_PARTS["17"]["run"] += time.perf_counter() - t1 - sum(saves)
    log(f"phase 17 run ({len(steps)} steps + eval): {time.perf_counter() - t1:.1f} s, the "
        f"state saves {[round(s, 1) for s in saves]} s; {json.dumps(record)}")
    log(f"phase 17 VQA step ms at 768 px, {LARGE_VQA_BATCH} questions in {LARGE_VQA_ACCUM} "
        f"microbatches, remat dots (CUDA events, wall): "
        f"{json.dumps([[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in steps])}; peak "
        f"device memory GiB {[round(r['peak_gib'], 2) for r in steps]}; eval calls "
        f"(B={VQA_EVAL_BATCH}, k_test {K_TEST}) ms (CUDA events, wall) "
        f"{[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in evals]}, peak GiB "
        f"{[round(r['peak_gib'], 2) for r in evals]}; {smi}")

    missing, unexpected = imported.get("missing"), imported.get("unexpected", [])
    rel_pos = imported.get("rel_pos", [])
    tables_ok = len(rel_pos) == mcfg.vision.depth and all(
        r == [[27 * 27 + 3, LARGE_HEADS], [95 * 95 + 3, LARGE_HEADS], True] for r in rel_pos)
    log(f"phase 17 import: {len(missing or [])} missing (fresh), unexpected {len(unexpected)} "
        f"({sorted({'.'.join(k.split('.')[:2]) for k in unexpected})}); {len(rel_pos)} rel-pos "
        f"tables interpolated 14 -> 48 as interp_rel_pos_table: {tables_ok}; accum_steps "
        f"{imported.get('accum_steps')}; the decoder at lr_mult: "
        f"{imported.get('decoder_at_lr_mult')}")
    leftover = ("vision_proj.", "text_proj.", "temp", "itm_head.", "text_encoder.cls.",
                "bbox_head.")
    if not missing or missing != imported["decoder"] or not unexpected or \
            not all(k.startswith(leftover) for k in unexpected) or not tables_ok or \
            imported.get("accum_steps") != LARGE_VQA_ACCUM or \
            not imported.get("decoder_at_lr_mult"):
        fail(f"large vqa launcher import of {th_path}: missing {missing}, unexpected "
             f"{unexpected}, rel-pos {rel_pos}, accum {imported.get('accum_steps')}, decoder "
             f"at lr_mult {imported.get('decoder_at_lr_mult')}")
    with open(os.path.join(out, "vqa_result.json")) as f:
        results = json.load(f)
    vals = [record.get(k) for k in ("eval_overall", "eval_acc", "loss_vqa", "loss_total")]
    # two saves: the one epoch's state and its best copy
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals) or \
            len(steps) != N_LARGE_VQA_TRAIN // LARGE_VQA_BATCH or len(evals) != 1 or \
            len(results) != VQA_EVAL_BATCH or len(saves) != 2 or \
            kept.get("step") != N_LARGE_VQA_TRAIN // LARGE_VQA_BATCH:
        fail(f"large vqa launcher: {len(steps)} steps, {len(evals)} eval calls, {len(results)} "
             f"results, {len(saves)} saves, record {record}")
    want_step, want_eval = large_vqa_launches(True), large_vqa_launches(False)
    for tag, records, want in (("step", steps, want_step), ("eval call", evals, want_eval)):
        for i, r in enumerate(records):
            got = dict(r["launches"], plain=r["plain"])
            if got != want:
                fail(f"large vqa launcher {tag} {i}: launches {got}, expected {want}")
    tiny = collections.Counter()
    for want, n in ((want_step, len(steps)), (want_eval, len(evals))):
        for shape, k in want["tiny_fwd"].items():
            tiny[shape] += k * n
    check_launcher_counts(
        "large vqa launcher", counts,
        want_step["flash_fwd"] * len(steps) + want_eval["flash_fwd"] * len(evals),
        want_step["flash_bwd"] * len(steps),
        {"tiny_fwd": dict(tiny),
         "tiny_bwd": {k: n * len(steps) for k, n in want_step["tiny_bwd"].items()}},
        n_plain=want_step["plain"] * len(steps) + want_eval["plain"] * len(evals))
    check_heads("large vqa launcher", counts, LARGE_HEADS)
    if counts["tiny_walks"]["tiny_attention_fwd"].get(TILED, 0) != \
            sum(n for (b, sq, skv), n in tiny.items() if skv == N_KEYS_768):
        fail(f"large vqa launcher: the 40 x {N_KEYS_768} launches are not all key-tiled: "
             f"{counts['tiny_walks']}")

    # the run's weights on the card: the split step against the unsplit one,
    # then a step's time and peak memory by remat policy
    t2 = time.perf_counter()
    final = kept.pop("params")
    batch = large_vqa_batch(cfg, LARGE_VQA_BATCH, args.seed)
    model = vqa_model(cfg, torch.bfloat16, dev, remat_train=True)
    model.load_state_dict(final)
    model.train()
    split = split_hold(model, batch, dev, vqa_cosine_params(mcfg))
    loss = split["loss_vqa"]
    log(f"phase 17 split hold on the card ({LARGE_VQA_BATCH} questions, dropout off, remat "
        f"dots): {json.dumps(split)}")
    if not abs(loss["split"] - loss["unsplit"]) <= 0.05 + 0.02 * abs(loss["unsplit"]) or \
            not all(math.isfinite(v) for v in loss.values()):
        fail(f"large vqa split step: loss_vqa {loss['split']:.5f} against the unsplit step's "
             f"{loss['unsplit']:.5f}")
    for k, c in split["cosine"].items():
        if not c >= 0.99:
            fail(f"large vqa split step: gradient {k} cosine to the unsplit step's {c:.5f}")
    del model
    torch.cuda.empty_cache()
    model = vqa_model(cfg, torch.bfloat16, dev, remat_train=False)
    model.load_state_dict(final)
    times = remat_step_times(model, cfg, batch, dev, LARGE_STEP_POLICIES)
    log(f"phase 17 train step by remat policy ({LARGE_VQA_BATCH} questions at 768 px in "
        f"{LARGE_VQA_ACCUM} microbatches, dropouts on, AdamW; CUDA-event ms of the second of "
        f"two steps, peak device GiB; {smi}): {json.dumps(times)}")
    del model
    torch.cuda.empty_cache()
    part_done("17", "card holds", t2)

    _, test_ds = create_dataset("vqa", cfg, rng=random.Random(args.seed))
    hold_batch = large_vqa_batch(cfg, 2, args.seed)
    hold_path = hold_state(final, "large_vqa.pt")
    del final
    defer_hold("phase 17 card bf16 vs CPU fp32 (2 questions, 4 answer rows, dropout off, "
               "remat dots)", vqa_hold, hold_path, cfg, hold_batch,
               {"answer_ids": torch.from_numpy(test_ds.answer_ids).long(),
                "answer_atts": torch.from_numpy(test_ds.answer_atts)}, dev, True)
    phase_seconds("17", t0)
    return split_counts(counts, [r["delta"] for r in steps])



# ---- phases 18-21: the shipped pretraining configs at their own sizes ----

BASE_1B_CONFIG = "configs/pretrain/x2vlm_base_1b.yaml"
LARGE_1B_CONFIG = "configs/pretrain/x2vlm_large_1b.yaml"
LARGE_STAGE2_CONFIG = "configs/pretrain/x2vlm_large_1b_stage2.yaml"
CCLM_LARGE_CONFIG = "configs/pretrain/multilingual_cclm_x2vlm_large.yaml"
CONFIG_STEPS = 2                     # phases 18-21: 2 steps, one epoch


def replaced_draws(seed: int, steps: int, aux_perc=None, video_aux_perc=None) -> list:
    """The batch kinds ``pretrain_loop`` draws at each of ``steps`` steps
    from ``random.Random(seed)``, as the launcher seeds it: "aux" / "noisy"
    where an aux stream replaces the image batch, then "video_aux" / "video"
    where a video-aux stream replaces the video batch."""
    rng = random.Random(seed)
    out = []
    for _ in range(steps):
        kinds = []
        if aux_perc is not None:
            kinds.append("aux" if rng.random() < aux_perc else "noisy")
        if video_aux_perc is not None:
            kinds.append("video_aux" if rng.random() < video_aux_perc else "video")
        out.append(tuple(kinds))
    return out


def seed_with_both_kinds(seed: int, steps: int, aux_perc=None, video_aux_perc=None):
    """The first ``--seed`` from ``seed`` on whose loop draws give each
    replaced stream both of its kinds within ``steps`` steps, and the
    draws: the replacement probabilities and the loop's seeding stay as
    shipped, and the run still sees both kinds."""
    for s in range(seed, seed + 1000):
        draws = replaced_draws(s, steps, aux_perc, video_aux_perc)
        if all(len({d[i] for d in draws}) == 2 for i in range(len(draws[0]))):
            return s, draws
    raise RuntimeError("no seed draws both kinds")


def recaption(src: str, dst: str, rng: np.random.Generator, words, key: str = "desc") -> None:
    """``src``'s image lines with new captions under ``key``: another stream
    over the same pixels, written without encoding a PNG."""
    with open(src) as fi, open(dst, "w") as fo:
        for line in fi:
            fo.write(json.dumps({"binary": json.loads(line)["binary"],
                                 key: caption(rng, words)}) + "\n")


def write_multilingual_regions(src: str, dst: str, rng: np.random.Generator, words) -> None:
    """Phase 7's region lines with each element's caption (and the image's)
    in 2-5 of ``CCLM_LANGS``: what ``code_switch`` draws a language from,
    caption by caption."""
    def ml(cap):
        first = cap[0] if isinstance(cap, list) else cap
        langs = list(rng.choice(CCLM_LANGS, int(rng.integers(2, 6)), replace=False))
        return {lang: first if lang == "en" else cclm_caption(rng, words, lang, 2, 10)
                for lang in langs}

    with open(src) as fi, open(dst, "w") as fo:
        for line in fi:
            ann = json.loads(line)
            ann["elems"] = [dict(e, caption=ml(e["caption"])) for e in ann["elems"]]
            if "caption" in ann:
                ann["caption"] = ml(ann["caption"])
            fo.write(json.dumps(ann, ensure_ascii=False) + "\n")


@contextlib.contextmanager
def code_switch_reading(seen: list):
    """Within the block, for each image ``RegionMultiTextStream`` localises,
    the languages its element captions were read in."""
    from x2vlm_tpu_torch.data.multilingual import RegionMultiTextStream

    orig = RegionMultiTextStream._localized

    def spy(self, ann):
        out = orig(self, ann)
        seen.append([next((lang for lang, c in e["caption"].items() if c == o["caption"]), "?")
                     for e, o in zip(ann["elems"], out["elems"])
                     if isinstance(e["caption"], dict)])
        return out

    RegionMultiTextStream._localized = spy
    try:
        yield
    finally:
        RegionMultiTextStream._localized = orig


def config_stream_launches(phase: str, stream: str, kind: str) -> tuple:
    """(flash launches by shape, tiny launches by shape, forward and backward
    alike) of one stream call of phases 18-21; ``kind`` is the image
    batch's ("aux", "noisy", or the stream's name without an aux stream) or
    the video batch's. A noisy batch runs no matching loss: its MLM goes
    through the whole stack from the masked text alone."""
    S, L, K = N_IMG, TEXT_LEN, 200
    if phase in ("18", "19"):   # base: 12 text + 6 fusion layers at 30 tokens; large: 18 + 6
        B = PRETRAIN_BATCH
        Lt, n_text = (B1B_LEN, 12) if phase == "18" else (L, L1B_FUSION)
        depth = 12 if phase == "18" else 24
        if stream == "image":
            tiny = ({(2 * B, Lt, Lt): n_text, (4 * B, Lt, Lt): 6, (4 * B, Lt, K): 6}
                    if kind == "aux" else
                    {(2 * B, Lt, Lt): n_text, (B, Lt, Lt): n_text + 6, (B, Lt, K): 6})
            return {(B, S, S): depth}, tiny
        R, n_img = ((B1B_REGION_ROWS, B1B_REGION_IMAGES) if phase == "18" else
                    (L1B_REGION_ROWS, L1B_REGION_IMAGES))
        return {(n_img, S, S): depth}, {(2 * R, Lt, Lt): n_text, (4 * R, Lt, Lt): 6,
                                        (4 * R, Lt, K): 6, (R, Lt, Lt): 6, (R, Lt, K): 6}
    if phase == "20":           # BEiT-2-large, 12 text + 6 fusion layers
        if stream == "video":
            V = S2L_VIDEOS
            return {(V * STREAM_FRAMES, S, S): 24}, {(2 * V, L, L): 12, (4 * V, L, L): 6,
                                                     (4 * V, L, K): 6}
        B = S2L_BATCH if stream == "image" else S2L_REGION_ROWS
        tiny = {(2 * B, L, L): 12, (4 * B, L, L): 6, (4 * B, L, K): 6}
        if stream == "region":
            tiny.update({(B, L, L): 6, (B, L, K): 6})
        return {(S2L_BATCH if stream == "image" else S2L_REGION_IMAGES, S, S): 24}, tiny
    # 21: BEiT-2-large, XLM-R of 24 layers, 6 cross layers
    flash = {"image": {(CL_BATCH, S, S): 24}, "region": {(CL_REGION_IMAGES, S, S): 24},
             "mtext": {}}[stream]
    return flash, cclm_stream_launches(stream, CL_BATCH, CL_BATCH, CL_BATCH, CL_TEXT_LAYERS)


def config_pretrain_phase(args, phase: str, rel: str, overrides: dict, sizes, want_sizes,
                          work: str, dev, smi: str = "", checkpoint: str = None,
                          hold=None, heads=(BASE_HEADS, BASE_HEADS), t0: float = None):
    """Phases 18-21: ``x2vlm_tpu_torch.run --task pretrain`` in process on
    the shipped config ``rel`` at its own sizes (``sizes(cfg)`` must give
    ``want_sizes``), its data paths set by ``overrides``, from ``--seed``
    weights or ``checkpoint``: ``CONFIG_STEPS`` steps of one epoch at the
    first seed whose loop draws give both kinds of each replaced stream
    (``seed_with_both_kinds``); each stream call timed (CUDA events, wall,
    peak GiB), its launches read against ``config_stream_launches`` and its
    matching flag against its kind; the state saved once, in memory
    (``kept_params_save``), its parameters kept for the deferred hold
    ``hold`` = (label, fn, extra args), called ``fn(params, mcfg, dev,
    *extra)``.
    ``heads`` = (flash, tiny) head counts; ``t0`` when the phase began
    writing its data. Returns the run's launches."""
    from x2vlm_tpu_torch import run as run_mod

    t0 = t0 or time.perf_counter()
    shipped = shipped_config(rel)
    cfg = dict(shipped, train_dataset_size=CONFIG_STEPS * shipped["images"]["batch_size"],
               **overrides)
    got_sizes = sizes(cfg)
    if got_sizes != want_sizes:
        fail(f"phase {phase}: the shipped config's sizes {got_sizes}, expected {want_sizes}")
    aux_perc = cfg.get("aux_iter_perc") if cfg.get("train_file_aux") else None
    video_aux_perc = (cfg.get("video_aux_iter_perc") if cfg.get("train_file_videos_aux")
                      else None)
    seed, draws = args.seed, [()] * CONFIG_STEPS
    if aux_perc is not None or video_aux_perc is not None:
        seed, draws = seed_with_both_kinds(args.seed, CONFIG_STEPS, aux_perc, video_aux_perc)
        log(f"phase {phase} draws (the loop's random.Random(--seed); aux_iter_perc "
            f"{aux_perc}, video_aux_iter_perc {video_aux_perc}): --seed {seed} draws "
            f"{draws} at steps 0-{CONFIG_STEPS - 1} (--seed {args.seed} would draw "
            f"{replaced_draws(args.seed, CONFIG_STEPS, aux_perc, video_aux_perc)})")
    mcfg = xvlm_config_from_yaml(cfg)
    cfg_path = os.path.join(work, f"config_{phase}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(work, f"out_{phase}")
    argv = ["--task", "pretrain", "--config", cfg_path, "--output_dir", out, "--seed",
            str(seed), "--device", dev.type, "--epoch", "1"]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    log(f"phase {phase} data and config ({rel}, remat {cfg.get('remat', False)}): "
        f"{part_done(phase, 'data', t0):.1f} s")

    t1 = time.perf_counter()
    saves, imported, switched, kept = [], {}, [], {}
    orig = {"save": ckpt_lib.save_train_state, "load": ckpt_lib.load_reference_checkpoint}
    timed_save = kept_params_save(kept, saves)

    def load(model, path):
        imported["missing"], imported["unexpected"] = orig["load"](model, path)
        return imported["missing"], imported["unexpected"]

    reset_counts()
    ckpt_lib.save_train_state, ckpt_lib.load_reference_checkpoint = timed_save, load
    try:
        with code_switch_reading(switched), StreamTimer(
                {(k, CONFIG_STEPS - 1) for k in ("image", "region", "video", "mtext")}
                if args.profile else None,
                (args, smi, f"chip_smoke_phase{phase}_{{stream}}_profile.txt")) as timer:
            record = run_mod.main(argv)
        check_data_plane(f"phase {phase}", record)
    finally:
        ckpt_lib.save_train_state, ckpt_lib.load_reference_checkpoint = \
            orig["save"], orig["load"]
    torch.cuda.synchronize()
    counts = launch_counts()
    PHASE_PARTS[phase]["save"] += sum(saves)
    PHASE_PARTS[phase]["run"] += time.perf_counter() - t1 - sum(saves)
    log(f"phase {phase} run ({CONFIG_STEPS} steps, --seed {seed}): "
        f"{time.perf_counter() - t1:.1f} s, the state save {[round(x, 1) for x in saves]} s; "
        f"{json.dumps(record)}")
    losses = [k for k in record if "_loss_" in k]
    if not losses or not all(isinstance(record[k], float) and math.isfinite(record[k])
                             for k in losses) or record.get("broken", -1) != 0 or \
            record.get("pretrain_steps") != [0, CONFIG_STEPS] or len(saves) != 1:
        fail(f"phase {phase} launcher: record {record}, {len(saves)} saves")
    if checkpoint:
        log(f"phase {phase} import of {checkpoint}: missing {imported.get('missing')}, "
            f"unexpected {imported.get('unexpected')}")
        if imported.get("missing") != ["absolute_frame_pos_embed"] or imported.get("unexpected"):
            fail(f"phase {phase} import: missing {imported.get('missing')}, unexpected "
                 f"{imported.get('unexpected')}; expected only the fresh frame positions")
    if cfg.get("regions", {}).get("languages"):
        mixed = [langs for langs in switched if len(set(langs)) > 1]
        log(f"phase {phase} code-switched region captions: {len(switched)} images read, "
            f"{len(mixed)} with their captions in more than one language, e.g. {mixed[:4]}")
        if not mixed:
            fail(f"phase {phase}: no image's region captions were code-switched")

    # each stream call's launches and matching flag, against its kind
    want_flash, want_tiny, by_call = 0, collections.Counter(), {}
    for stream, calls in timer.calls.items():
        if stream == "apply":
            continue
        if len(calls) != CONFIG_STEPS:
            fail(f"phase {phase}: {len(calls)} {stream}-stream calls, expected {CONFIG_STEPS}")
        for i, c in enumerate(calls):
            kind = (draws[i][0] if stream == "image" and aux_perc is not None else
                    draws[i][-1] if stream == "video" and video_aux_perc is not None else
                    stream)
            flash, tiny = config_stream_launches(phase, stream, kind)
            tag = f"phase {phase} {stream} call {i} ({kind})"
            n_flash = sum(flash.values())
            check_launcher_counts(tag, c["launches"], n_flash, n_flash,
                                  {"tiny_fwd": tiny, "tiny_bwd": tiny})
            if dict(c["launches"]["flash_fwd_shapes"]) != flash:
                fail(f"{tag}: flash shapes {dict(c['launches']['flash_fwd_shapes'])}, "
                     f"expected {flash}")
            want_itm = None if stream == "mtext" else kind != "noisy"
            if c["itm"] != want_itm:
                fail(f"{tag}: matching loss {c['itm']}, expected {want_itm}")
            want_flash += n_flash
            want_tiny.update(tiny)
            by_call[f"{stream} {i} ({kind})"] = [round(c["ms"], 3), round(c["wall_ms"], 3),
                                                 round(c["peak_gib"], 2)]
    check_launcher_counts(f"phase {phase} launcher", counts, want_flash, want_flash,
                          {"tiny_fwd": dict(want_tiny), "tiny_bwd": dict(want_tiny)})
    check_heads(f"phase {phase} launcher", counts, *heads)
    log(f"phase {phase} stream calls (CUDA-event ms, wall ms, peak GiB; {smi}): "
        f"{json.dumps(by_call)}")
    log(f"phase {phase} by stream (median; the largest peak; apply: the AdamW step): "
        f"{json.dumps(timer.summary())}")

    t2 = time.perf_counter()
    if len(saves) != 1 or kept.get("step") != CONFIG_STEPS:
        fail(f"phase {phase}: {len(saves)} state saves, the last at step {kept.get('step')}")
    params = hold_state(kept.pop("params"), f"phase{phase}.pt")
    shutil.rmtree(out, ignore_errors=True)
    part_done(phase, "state to hold", t2)
    if hold is not None:
        label, fn, extra = hold
        defer_hold(label, fn, params, mcfg, dev, *extra)
    del params
    phase_seconds(phase, t0)
    return counts


def base_1b_phase(args, root: str, tok_dir: str, words, work: str, dev, smi: str = ""):
    """Phase 18: the shipped ``x2vlm_base_1b.yaml`` from ``--seed``: 128
    images at 30 tokens beside the clean-data aux stream (``aux_iter_perc``
    0.15, captions under ``aux_caption_key``; phase 7's pixels recaptioned),
    64 region rows over 26 images at ``iter_perc`` 0.5, ``stop_calc_itm``
    200,000; an aux and a noisy batch both run. Hold: an aux batch, the
    same as a noisy batch (no matching loss) and a region batch at 30
    tokens."""
    t0 = time.perf_counter()
    aux_file = os.path.join(work, "aux_1b.jsonl")
    recaption(os.path.join(root, "images.jsonl"), aux_file,
              np.random.default_rng(args.seed + 18), words)
    overrides = {"train_file": [os.path.join(root, "images.jsonl")],
                 "train_file_aux": [aux_file],
                 "train_file_regions": [os.path.join(root, "regions.jsonl")],
                 "text_encoder": tok_dir}

    def sizes(c):
        return (c["images"]["batch_size"], c["images"]["aux_caption_key"], c["aux_iter_perc"],
                c["max_tokens"], c["regions"]["batch_size"], c["regions"]["max_images"],
                c["regions"]["iter_perc"], c["stop_calc_itm"], c["text_num_hidden_layers"],
                c["text_fusion_start_at"])

    return config_pretrain_phase(
        args, "18", BASE_1B_CONFIG, overrides, sizes,
        (PRETRAIN_BATCH, "desc", 0.15, B1B_LEN, B1B_REGION_ROWS, B1B_REGION_IMAGES, 0.5,
         200000, 18, 12), work, dev, smi,
        hold=("phase 18 card bf16 vs CPU fp32 (x2vlm_base_1b: 2 images as an aux and a noisy "
              "batch, 2 region rows, 30 tokens; dropout off)", large_pretrain_hold,
              (B1B_LEN, True)), t0=t0)


def large_1b_phase(args, root: str, large_tok: str, words, work: str, dev, smi: str = ""):
    """Phase 19: the shipped ``x2vlm_large_1b.yaml`` from ``--seed``
    (BEiT-2-large, a 24-layer BERT-large stack fusing from 18; 16 heads
    everywhere): 128 images beside the aux stream at 0.15, 128 region rows
    over 50 images; an aux and a noisy batch both run; each stream call's
    peak memory read. No remat, as shipped: a probe run on the card read
    74.04 GiB at the aux image call's peak (PERF.md §6). Hold: the
    24-layer stack on an aux, a noisy and a region batch at the run's own
    weights, the ITM head's first weight term by term (``itm_term_faults``):
    there the ITM rows' p - y nearly cancel over the random stack's
    collapsed features (ITM loss 0.640 against 0.637 at p = 1/3), and the
    summed gradient's cosine reads 0.989-0.991 against CPU fp32 on the card
    and 0.991 on the CPU in bf16 with no kernel (PERF.md §6)."""
    t0 = time.perf_counter()
    aux_file = os.path.join(work, "aux_1b.jsonl")
    recaption(os.path.join(root, "images.jsonl"), aux_file,
              np.random.default_rng(args.seed + 19), words)
    overrides = {"train_file": [os.path.join(root, "images.jsonl")],
                 "train_file_aux": [aux_file],
                 "train_file_regions": [os.path.join(root, "regions.jsonl")],
                 "text_encoder": large_tok}

    def sizes(c):
        return (c["images"]["batch_size"], c["aux_iter_perc"], c["max_tokens"],
                c["regions"]["batch_size"], c["regions"]["max_images"],
                c["text_num_hidden_layers"], c["text_fusion_start_at"], c["image_res"])

    return config_pretrain_phase(
        args, "19", LARGE_1B_CONFIG, overrides, sizes,
        (PRETRAIN_BATCH, 0.15, TEXT_LEN, L1B_REGION_ROWS, L1B_REGION_IMAGES, L1B_TEXT_LAYERS,
         L1B_FUSION, 224), work, dev, smi,
        hold=("phase 19 card bf16 vs CPU fp32 (x2vlm_large_1b, 24 text layers fusing from 18, "
              "the run's weights, the ITM head term by term: 2 images as an aux and a noisy "
              "batch, 2 region rows; dropout off)", large_pretrain_hold, (TEXT_LEN, True, True)),
        heads=(LARGE_HEADS, LARGE_HEADS), t0=t0)


def large_stage2_phase(args, root: str, large_tok: str, words, th_path: str, work: str, dev,
                       smi: str = ""):
    """Phase 20: the shipped ``x2vlm_large_1b_stage2.yaml`` from phase 16's
    ``.th`` (its frame positions fresh): 32 images, 32 region rows over 14
    images, 20 clips of 3 frames (``video_frames`` / ``text`` lines written
    here; the clip-of-clips lines combined to 8 frames) beside the
    video-aux stream at 0.35 (the same frames recaptioned); a video and a
    video-aux batch both run. Hold: 2 videos of 3 frames."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 20)
    video_file, aux_file = (os.path.join(work, "videos_large.jsonl"),
                            os.path.join(work, "videos_large_aux.jsonl"))
    write_video_corpus(video_file, rng, words, frames_key="video_frames", caption_key="text")
    with open(video_file) as fi, open(aux_file, "w") as fo:
        for line in fi:
            fo.write(json.dumps(dict(json.loads(line), text=caption(rng, words))) + "\n")
    overrides = {"train_file": [os.path.join(root, "images.jsonl")],
                 "train_file_regions": [os.path.join(root, "regions.jsonl")],
                 "train_file_videos": [video_file], "train_file_videos_aux": [aux_file],
                 "text_encoder": large_tok}

    def sizes(c):
        return (c["images"]["batch_size"], c["regions"]["batch_size"],
                c["regions"]["max_images"], c["videos"]["batch_size"], c["videos"]["frame_len"],
                c["video_aux_iter_perc"], c["video_encoding"], c["add_frame_pos"])

    return config_pretrain_phase(
        args, "20", LARGE_STAGE2_CONFIG, overrides, sizes,
        (S2L_BATCH, S2L_REGION_ROWS, S2L_REGION_IMAGES, S2L_VIDEOS, STREAM_FRAMES, 0.35,
         "avgpool", True), work, dev, smi, checkpoint=th_path,
        hold=("phase 20 card bf16 vs CPU fp32 (x2vlm_large_1b_stage2: 2 videos x 3 frames; "
              "negatives injected, dropout off)", video_pretrain_hold, ()),
        heads=(LARGE_HEADS, LARGE_HEADS), t0=t0)


def cclm_large_phase(args, root: str, plus_work: str, tok_dir: str, words, dev,
                     smi: str = ""):
    """Phase 21: the shipped ``multilingual_cclm_x2vlm_large.yaml`` from
    ``--seed`` (an X2VLM-large ``.th`` does not load: its 1024-wide fusion
    layers against the 768-wide cross encoder of the JAX factory's XLM-R
    preset, refused by both launchers; ROADMAP C): BEiT-2-large (16 heads),
    XLM-R of 24 layers and 6 cross layers (12 heads); 30 images with
    captions in the 8 languages (phase 14's), 30 region rows over 14
    images with ``code_switch`` over the block's ``languages`` (phase 7's
    region lines in 2-5 languages a caption); phase 14's XLM-R tokenizer.
    The parallel-text block (30 pairs of 64 tokens) is asserted as shipped
    but not run: with the text tower 768 wide and the vision tower 1024,
    the cross encoder's cross-attention (1024-wide keys) cannot take
    language 2's 768-wide states, and both packages raise there (ROADMAP
    C). Hold: 2 images and 2 region rows."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 21)
    regions = os.path.join(plus_work, "regions_ml.jsonl")
    write_multilingual_regions(os.path.join(root, "regions.jsonl"), regions, rng, words)
    overrides = {"train_file": [os.path.join(plus_work, "images_ml.jsonl")],
                 "train_file_regions": [regions], "train_file_mtext": [],
                 "text_encoder": tok_dir}

    def sizes(c):
        return (c["model_type"], c["images"]["batch_size"], c["regions"]["batch_size"],
                c["regions"]["max_images"], c["regions"]["code_switch"],
                tuple(c["regions"]["languages"]), c["mtexts"]["batch_size"],
                c["mtexts"]["max_tokens"], c["text_num_hidden_layers"], c["num_cross_layers"])

    return config_pretrain_phase(
        args, "21", CCLM_LARGE_CONFIG, overrides, sizes,
        ("cclm", CL_BATCH, CL_BATCH, CL_REGION_IMAGES, True, CCLM_LANGS, CL_BATCH, CCLM_LEN,
         CL_TEXT_LAYERS, 6), plus_work, dev, smi,
        hold=("phase 21 card bf16 vs CPU fp32 (multilingual_cclm_x2vlm_large: 2 images, 2 "
              "code-switched region rows; negatives injected, dropout off)", cclm_hold,
              (False,)),
        heads=(LARGE_HEADS, BASE_HEADS), t0=t0)


# ---- phases 22 and 23: the two large fine-tunes at their own sizes ----

LARGE_GROUNDING_CONFIG = "configs/finetune/refcoco_grounding_large.yaml"
LARGE_CAPTION_CONFIG = "configs/finetune/coco_captioning_large.yaml"
LARGE_FT_STEPS = 2                   # phases 22 and 23: 2 steps in one epoch, then the eval
DROP_PATH_SEED = 22                  # the keep masks both passes of a held step draw


@contextlib.contextmanager
def injected_drop_path(seed: int, dropped: list):
    """Within the block, every drop path keeps the rows a CPU generator
    seeded with ``seed`` draws (``ops.layers.drop_path_keep`` replaced; the
    masks are moved to the layer's device), so a step held on the card and
    on the CPU drops the same rows; the rows dropped a call are appended to
    ``dropped``."""
    from x2vlm_tpu_torch.ops import layers as layers_mod

    g = torch.Generator().manual_seed(seed)
    orig = layers_mod.drop_path_keep

    def keep(shape, keep_prob, generator, device):
        mask = torch.rand(shape, generator=g) < keep_prob
        dropped.append(int((~mask).sum()))
        return mask.to(device)

    layers_mod.drop_path_keep = keep
    try:
        yield dropped
    finally:
        layers_mod.drop_path_keep = orig


def attention_dropout_off(mcfg):
    """``mcfg`` with the attention and hidden dropouts at 0 and every
    drop-path rate kept (the hold injects its keep masks)."""
    return dataclasses.replace(
        mcfg, vision=dataclasses.replace(mcfg.vision, dropout_rate=0.0, attn_dropout_rate=0.0),
        text=dataclasses.replace(mcfg.text, hidden_dropout=0.0, attn_dropout=0.0))


def large_ft_launches(task: str, train: bool) -> dict:
    """The attention launches of one phase-22 / 23 train step or eval call
    at 16 heads: 24 flash (the vision pass at S=577); grounding (step 20
    rows, eval 32) tiny at 40 x 40 (12 text layers, 6 fusion
    self-attentions) and 40 x 584 (6 fusion cross-attentions, key-tiled);
    captioning tiny only for the 6 cross-attentions, key-tiled: a step at
    16 x 58 x 584 (FG-free: 40 + 18 tokens), its 18 self-attentions on the
    plain core (the UniLM attention matrix); an eval call frame 0 at 20 x
    (prompt + 1) x 584, then 49 frames of 2 queries over the 3 x 20
    beams, 18 plain self-attentions a frame. The backward as the forward
    in training."""
    if task == "grounding":
        B = LG_BATCH if train else LG_EVAL_BATCH
        tiny, plain = {(B, TEXT_LEN, TEXT_LEN): 18, (B, TEXT_LEN, N_KEYS_384): 6}, 0
    elif train:
        tiny, plain = {(LC_BATCH, LC_TOKENS, N_KEYS_384): 6}, 18
    else:
        tiny = {(LC_EVAL_BATCH, CAP_PROMPT + 1, N_KEYS_384): 6,
                (CAP_BEAMS * LC_EVAL_BATCH, 2, N_KEYS_384): 6 * (LC_MAX_LEN - 1)}
        plain = 18 * LC_MAX_LEN
    return {"flash_fwd": 24, "flash_bwd": 24 if train else 0, "tiny_fwd": tiny,
            "tiny_bwd": tiny if train else {}, "plain": plain}


def large_ft_hold(task: str, state, cfg: dict, batch: dict, dev) -> tuple:
    """One step of phase 22 / 23's fine-tuned weights ``state`` (or the
    train state saved at that path) on 2 rows in training mode, the
    attention and hidden dropouts off and every drop path on at its rate,
    its keep masks injected (``injected_drop_path``: both passes drop the
    same rows): the card in bf16 against the port's CPU fp32 path, each
    loss within 0.05 + 2%, the gradient cosines of
    ``finetune_cosine_params`` (grounding's bbox head) or
    ``caption_cosine_params`` >= 0.99, each bf16 x 584 forward and backward
    call held on the model's operands within ``FUSION_CALL_RATIO`` of the
    bf16 rule's bound; grounding's boxes (eval mode) within 0.02 and its
    targets ``off_kink_targets`` of the CPU path's boxes. Returns the
    readings and the faults found."""
    from x2vlm_tpu_torch.models import XVLMForGrounding, XVLMForMLMCaptioning

    state = params_of(state)
    mcfg = attention_dropout_off(xvlm_config_from_yaml(cfg))
    names = (finetune_cosine_params(mcfg, "bbox_head") if task == "grounding"
             else caption_cosine_params(mcfg))
    fwd_ratios, bwd_ratios, losses, grads, dropped, boxes = [], [], {}, {}, {}, {}
    for tag, dtype, device in (("cpu", torch.float32, torch.device("cpu")),
                               ("card", torch.bfloat16, dev)):
        model = (XVLMForGrounding(mcfg, dtype=dtype, device=device, seed=None)
                 if task == "grounding" else
                 XVLMForMLMCaptioning(mcfg, label_smoothing=cfg["label_smoothing"],
                                      dtype=dtype, device=device, seed=None))
        model.load_state_dict(state)
        b = {k: v.to(device) for k, v in batch.items()}
        if task == "grounding":
            with torch.no_grad():
                boxes[tag] = model.predict(b["image"], b["text_ids"], b["text_atts"]).float()
            if tag == "cpu":
                batch["target_bbox"] = off_kink_targets(boxes["cpu"])
                b["target_bbox"] = batch["target_bbox"]
            boxes[tag] = boxes[tag].cpu()
        model.train()
        with held_tiny_calls(N_KEYS_384, fwd_ratios), held_tiny_bwd_calls(N_KEYS_384,
                                                                          bwd_ratios), \
                injected_drop_path(DROP_PATH_SEED, dropped.setdefault(tag, [])):
            out = model(b)
            sum(out.values()).backward()
        losses[tag] = {k: v.item() for k, v in out.items()}
        params = dict(model.named_parameters())
        grads[tag] = {k: params[k].grad.detach().double().cpu().reshape(-1) for k in names}
        del model, out, params, b
    torch.cuda.empty_cache()
    cos = {k: F.cosine_similarity(grads["card"][k], grads["cpu"][k], dim=0).item()
           for k in names}
    r = {"losses": losses, "cosine": cos, "fwd_ratios": fwd_ratios, "bwd_ratios": bwd_ratios,
         "drop_path_calls": len(dropped["card"]), "rows_dropped": sum(dropped["card"])}
    faults = []
    if dropped["card"] != dropped["cpu"] or not sum(dropped["card"]):
        faults.append(f"drop path: rows dropped a call {dropped['card']} on the card, "
                      f"{dropped['cpu']} on the CPU (the same, and some)")
    if task == "grounding":
        r["box_err"] = max_err(boxes["card"], boxes["cpu"])
        if not r["box_err"] <= 0.02:
            faults.append(f"boxes off the CPU fp32 path's by {r['box_err']:.4f} > 0.02")
    for kind, ratios in (("forward", fwd_ratios), ("backward", bwd_ratios)):
        if len(ratios) != 6 or not all(x <= FUSION_CALL_RATIO for x in ratios):
            faults.append(f"the x {N_KEYS_384} {kind} calls' errors over the bf16 rule's "
                          f"bound {[round(x, 3) for x in ratios]}, expected 6 at most "
                          f"{FUSION_CALL_RATIO}")
    for k, ref in losses["cpu"].items():
        if not abs(losses["card"][k] - ref) <= 0.05 + 0.02 * abs(ref):
            faults.append(f"{k}: card {losses['card'][k]:.5f} vs CPU fp32 {ref:.5f}")
    for k, c in cos.items():
        if not c >= 0.99:
            faults.append(f"gradient {k}: cosine to the CPU fp32 path {c:.5f} < 0.99")
    return r, faults


def lr_scale_faults(opt, labels: dict, cfg: dict) -> tuple:
    """The optimizer's scale of each parameter against the YAML's groups:
    the vision tower's ``vision_lr`` / ``lr``, the text tower's ``text_lr``
    / ``lr``, the cross layers' ``cross_lr`` / ``lr``, a fresh head's
    ``lr_mult``, the rest 1, by the parameters' ``labels``
    (``train.param_labels``). Returns (the scales by label, faults)."""
    o = cfg["optimizer"]
    lr = float(o["lr"])
    want = {"vision": float(o.get("vision_lr", lr)) / lr, "text": float(o.get("text_lr", lr)) / lr,
            "cross": float(o.get("cross_lr", lr)) / lr, "fresh": float(o.get("lr_mult", 1.0)),
            "other": 1.0}
    scale = {opt.names[i]: s for (_, s), idx in opt.groups for i in idx}
    seen = collections.defaultdict(set)
    for name, s in scale.items():
        seen[labels[name]].add(s)
    faults = [f"{label}: scales {sorted(s)}, the YAML gives {want[label]}"
              for label, s in seen.items() if s != {want[label]}]
    return {k: sorted(v) for k, v in seen.items()}, faults


def large_ft_phase(args, task: str, root: str, th_path: str, large_tok: str, words,
                   image_root: str, work: str, dev, smi: str = "") -> dict:
    """Phase 22 (``task`` grounding) or 23 (captioning):
    ``x2vlm_tpu_torch.run --task <task>`` in process on the shipped
    ``refcoco_grounding_large.yaml`` / ``coco_captioning_large.yaml`` at
    their own sizes (384 px, 16 heads; grounding 20 rows a step and 32 an
    eval call, text and cross drop path 0.1, ``careful_hflip``, ``lr_mult``
    2; captioning 16 images a step at 58 FG-free tokens, label smoothing
    0.1, 20 images an eval call, 3 beams, 5 to 50 frames, ``vision_lr`` /
    ``text_lr``) from phase 16's ``.th`` (the 24 rel-pos tables
    interpolated 14 -> 24), on lines written over phase 8's PNGs: one epoch
    of 2 steps and its eval, each step and eval call timed (CUDA events,
    wall, peak GiB) and its launches read (``large_ft_launches``); the
    optimizer's scale of each parameter held to the YAML's groups; the
    state saved in memory (``kept_params_save``); then ``large_ft_hold``
    on 2 rows deferred. Returns the launches split into
    the steps' and the eval's."""
    from x2vlm_tpu_torch import run as run_mod
    from x2vlm_tpu_torch.data.factory import create_dataset
    from x2vlm_tpu_torch.data.loader import collate
    from x2vlm_tpu_torch.data.tokenization import build_tokenizer
    from x2vlm_tpu_torch.tasks import captioning as cap_mod, grounding as grounding_mod

    phase = "22" if task == "grounding" else "23"
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + int(phase))
    n_images = len(os.listdir(image_root))
    if task == "grounding":
        shipped = shipped_config(LARGE_GROUNDING_CONFIG)
        train, test, refs = write_grounding_corpus(root, rng, words, n_images,
                                                   LG_BATCH * LARGE_FT_STEPS, LG_EVAL_BATCH,
                                                   "refcoco_large")
        cfg = dict(shipped, image_root=image_root, text_encoder=large_tok, train_file=[train],
                   test_file=[test], refs_file=refs)
        sizes = (cfg["batch_size"], cfg["batch_size_test"], cfg["max_tokens"],
                 cfg["image_res"], cfg["careful_hflip"], cfg["text_drop_path_rate"],
                 cfg["cross_drop_path_rate"], cfg["optimizer"]["lr_mult"])
        want_sizes = (LG_BATCH, LG_EVAL_BATCH, TEXT_LEN, 384, True, 0.1, 0.1, 2)
        eval_mod, eval_name, rel = grounding_mod, "predict_grounding", LARGE_GROUNDING_CONFIG
    else:
        shipped = shipped_config(LARGE_CAPTION_CONFIG)
        train, test, gt = write_caption_corpus(root, rng, words, n_images,
                                               LC_BATCH * LARGE_FT_STEPS, LC_EVAL_BATCH,
                                               "caption_large")
        cfg = dict(shipped, image_root=image_root, text_encoder=large_tok, train_file=[train],
                   test_file=[test], caption_gt_file=gt)
        o = cfg["optimizer"]
        sizes = (cfg["batch_size"], cfg["batch_size_test"], cfg["fg_free"], cfg["max_tokens"],
                 cfg["max_masks"], cfg["label_smoothing"], cfg["num_beams"],
                 cfg["max_length"], cfg["min_length"], cfg["prompt"], cfg["image_res"],
                 float(o["vision_lr"]), float(o["text_lr"]), cfg["start_eval"])
        want_sizes = (LC_BATCH, LC_EVAL_BATCH, True, TEXT_LEN, LC_TOKENS - TEXT_LEN, 0.1,
                      CAP_BEAMS, LC_MAX_LEN, 5, "a picture of ", 384, 1e-5, 5e-6, 0)
        eval_mod, eval_name, rel = cap_mod, "beam_search_generate_device", LARGE_CAPTION_CONFIG
        prompt = cap_mod.prompt_ids(build_tokenizer(large_tok), cfg["prompt"])
        if len(prompt) != CAP_PROMPT:
            fail(f"phase 23: the prompt is {len(prompt)} tokens, phase 2's shapes assume "
                 f"{CAP_PROMPT}")
    if sizes != want_sizes:
        fail(f"phase {phase} ({rel}): the shipped config's sizes {sizes} changed from "
             f"{want_sizes}")
    mcfg = xvlm_config_from_yaml(cfg)
    cfg_path = os.path.join(root, f"{task}_large.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(work, f"out_{task}_large")
    log(f"phase {phase} data and config: {part_done(phase, 'data', t0):.1f} s")

    imported, steps, evals, saves, kept = {}, [], [], [], {}
    orig = {"load": ckpt_lib.load_reference_checkpoint, "save": ckpt_lib.save_train_state,
            "step": run_mod.make_train_step, "optimizer": run_mod.make_optimizer,
            "eval": getattr(eval_mod, eval_name)}
    timed = functools.partial(timed_call, args, smi)
    table_key = "vision_encoder.blocks.0.attn.relative_position_bias_table"

    def load(model, path):
        imported["missing"], imported["unexpected"] = orig["load"](model, path)
        src = torch.load(path, map_location="cpu", weights_only=False, mmap=True)["model"]
        got = model.state_dict()
        imported["rel_pos"] = []
        for i in range(mcfg.vision.depth):
            key = table_key.replace(".0.", f".{i}.")
            t = src[key].float().numpy()
            want = ckpt_lib.interp_rel_pos_table(t, 14, 24)
            imported["rel_pos"].append([list(t.shape), list(got[key].shape),
                                        bool(np.array_equal(got[key].cpu().numpy(), want))])
        return imported["missing"], imported["unexpected"]

    def make_optimizer(cfg_, model, total_steps, fusion_layer, fresh_names=()):
        from x2vlm_tpu_torch.train import param_labels

        opt = orig["optimizer"](cfg_, model, total_steps, fusion_layer, fresh_names)
        labels = param_labels(model.named_parameters(), fusion_layer, fresh_names=fresh_names)
        imported["scales"], imported["scale_faults"] = lr_scale_faults(opt, labels, cfg)
        return opt

    def make_step(model, optimizer, **kw):
        return timed(orig["step"](model, optimizer, **kw), steps,
                     f"chip_smoke_{task}_large_step_profile.txt",
                     lambda i: args.profile and i == LARGE_FT_STEPS - 1)

    def patch(on: bool):
        ckpt_lib.load_reference_checkpoint = load if on else orig["load"]
        ckpt_lib.save_train_state = kept_params_save(kept, saves) if on else orig["save"]
        run_mod.make_train_step = make_step if on else orig["step"]
        run_mod.make_optimizer = make_optimizer if on else orig["optimizer"]
        setattr(eval_mod, eval_name, timed(orig["eval"], evals,
                                           f"chip_smoke_{task}_large_eval_profile.txt",
                                           lambda i: bool(args.profile) and i == 0)
                if on else orig["eval"])

    argv = ["--task", task, "--config", cfg_path, "--checkpoint", th_path, "--epoch", "1",
            "--seed", str(args.seed), "--device", dev.type, "--output_dir", out]
    t1 = time.perf_counter()
    reset_counts()
    patch(True)
    try:
        record = run_mod.main(argv)
    finally:
        patch(False)
    torch.cuda.synchronize()
    counts = launch_counts()
    PHASE_PARTS[phase]["save"] += sum(saves)
    PHASE_PARTS[phase]["run"] += time.perf_counter() - t1 - sum(saves)
    log(f"phase {phase} run ({len(steps)} steps + eval): {time.perf_counter() - t1:.1f} s, the "
        f"state saves {[round(s, 1) for s in saves]} s; {json.dumps(record)}")
    log(f"phase {phase} {task} step ms at 384 px, B={LG_BATCH if task == 'grounding' else LC_BATCH}"
        f" (CUDA events, wall): "
        f"{json.dumps([[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in steps])}; peak "
        f"device memory GiB {[round(r['peak_gib'], 2) for r in steps]}; eval calls ms (CUDA "
        f"events, wall) {[[round(r['ms'], 3), round(r['wall_ms'], 3)] for r in evals]}, peak "
        f"GiB {[round(r['peak_gib'], 2) for r in evals]}; {smi}")

    missing, unexpected = imported.get("missing"), imported.get("unexpected", [])
    rel_pos = imported.get("rel_pos", [])
    tables_ok = len(rel_pos) == mcfg.vision.depth and all(
        r == [[27 * 27 + 3, LARGE_HEADS], [47 * 47 + 3, LARGE_HEADS], True] for r in rel_pos)
    log(f"phase {phase} import: missing {missing}, unexpected {len(unexpected)} "
        f"({sorted({'.'.join(k.split('.')[:2]) for k in unexpected})}); {len(rel_pos)} rel-pos "
        f"tables interpolated 14 -> 24 as interp_rel_pos_table: {tables_ok}; learning-rate "
        f"scales by label {imported.get('scales')}")
    leftover = ("vision_proj.", "text_proj.", "temp", "itm_head.") + (
        ("text_encoder.cls.",) if task == "grounding" else ("bbox_head.",))
    if missing != [] or not unexpected or not all(k.startswith(leftover) for k in unexpected) \
            or not tables_ok:
        fail(f"phase {phase} import of {th_path}: missing {missing}, unexpected {unexpected}, "
             f"rel-pos {rel_pos}")
    if imported.get("scale_faults", ["no optimizer"]):
        fail(f"phase {phase} learning rates: {imported.get('scale_faults', 'no optimizer')}")
    eval_keys = (("val_acc", "testA_acc", "testB_acc") if task == "grounding"
                 else ("bleu1", "bleu4", "cider", "rouge_l", "meteor"))
    vals = [record.get(f"eval_{k}") for k in eval_keys] + [record.get("loss_total")]
    # two saves: the one epoch's state and its best copy
    if not all(isinstance(v, float) and math.isfinite(v) for v in vals) or \
            len(steps) != LARGE_FT_STEPS or len(evals) != 1 or len(saves) != 2 or \
            kept.get("step") != LARGE_FT_STEPS:
        fail(f"phase {phase}: {len(steps)} steps, {len(evals)} eval calls, {len(saves)} saves, "
             f"record {record}")
    want_step, want_eval = large_ft_launches(task, True), large_ft_launches(task, False)
    for tag, records, want in (("step", steps, want_step), ("eval call", evals, want_eval)):
        for i, r in enumerate(records):
            got = dict(r["launches"], plain=r["plain"])
            if got != want:
                fail(f"phase {phase} {tag} {i}: launches {got}, expected {want}")
    tiny = collections.Counter()
    for want, n in ((want_step, len(steps)), (want_eval, len(evals))):
        for shape, k in want["tiny_fwd"].items():
            tiny[shape] += k * n
    check_launcher_counts(
        f"phase {phase} launcher", counts,
        want_step["flash_fwd"] * len(steps) + want_eval["flash_fwd"] * len(evals),
        want_step["flash_bwd"] * len(steps),
        {"tiny_fwd": dict(tiny),
         "tiny_bwd": {k: n * len(steps) for k, n in want_step["tiny_bwd"].items()}},
        n_plain=want_step["plain"] * len(steps) + want_eval["plain"] * len(evals))
    check_heads(f"phase {phase} launcher", counts, LARGE_HEADS)
    if counts["tiny_walks"]["tiny_attention_fwd"].get(TILED, 0) != \
            sum(n for (b, sq, skv), n in tiny.items() if skv == N_KEYS_384):
        fail(f"phase {phase}: the x {N_KEYS_384} launches are not all key-tiled: "
             f"{counts['tiny_walks']}")

    # the run's weights: one step on 2 rows, card bf16 against CPU fp32
    # with the drop paths' keep masks injected (deferred)
    t2 = time.perf_counter()
    train_ds, _ = create_dataset(task, cfg, rng=random.Random(args.seed))
    batch = {k: torch.from_numpy(v) for k, v in collate([train_ds[0], train_ds[1]]).items()
             if k != "ref_id"}
    hold_path = hold_state(kept.pop("params"), f"phase{phase}.pt")
    shutil.rmtree(out, ignore_errors=True)
    part_done(phase, "state to hold", t2)
    defer_hold(f"phase {phase} card bf16 vs CPU fp32 ({task}, 2 rows, training mode, attention "
               f"dropout off, drop path on with injected keep masks)", large_ft_hold, task,
               hold_path, cfg, batch, dev)
    phase_seconds(phase, t0)
    return split_counts(counts, [r["delta"] for r in steps])


def native_dataplane() -> None:
    """Build the native data plane (``data/native.py``: ``g++`` with the
    libjpeg / libpng headers) and, where it builds, hold each of its pixel
    ops against PIL by the per-op rules (``pil_parity_failures``); where it
    does not, say why on a line of its own. Sets ``NATIVE``."""
    from x2vlm_tpu_torch.data import native as native_mod

    t = time.perf_counter()
    NATIVE["available"] = native_mod.native_available()
    if not NATIVE["available"]:
        log(f"native dataplane: unavailable ({native_mod.unavailable_reason()})")
        return
    log(f"native dataplane: built in {time.perf_counter() - t:.1f} s "
        f"({native_mod.lib_path().name})")
    bad = native_mod.pil_parity_failures()
    log(f"native dataplane against PIL, per op: {json.dumps(bad) if bad else 'every op holds'}")
    if bad:
        fail(f"native dataplane against PIL: {bad}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="write torch.profiler tables of one round of requests and "
                         "one train step to DIR")
    ap.add_argument("--phase24-child", metavar="SPEC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the port "
              "on the GPU", file=sys.stderr)
        return 2
    if args.phase24_child:   # phase 24's rank, started by torchrun
        return phase24_child(args.phase24_child)
    return run(args, torch.device("cuda", 0))


def run(args, dev: torch.device) -> int:
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    cores = len(os.sched_getaffinity(0))
    if torch.get_num_threads() < cores:   # the CPU fp32 holds of phases 6-8, 12, 13
        torch.set_num_threads(cores)
    log(f"torch CPU threads: {torch.get_num_threads()} of {cores} cores")
    open_holds(cores)
    try:
        return _run(args, dev, smi, t_start)
    finally:
        close_holds()


def _run(args, dev: torch.device, smi: str, t_start: float) -> int:
    """``run`` with the holds' worker open."""

    # g++ builds the native data plane, and phase 7's data is written, while
    # the nvcc processes run
    root_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        native_build = pool.submit(native_dataplane)
        pretrain_data = pool.submit(write_pretrain_data, root_dir.name, args.seed)
        secs = _build.build()
        log(f"build: {json.dumps({k: round(v, 1) for k, v in secs.items()})}")
        native_build.result()
        pretrain_data = pretrain_data.result()
    for name in _build.KERNELS:
        log(f"ptxas {name}:\n{_build.ptxas_report(name)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    with torch.inference_mode():
        flash_entries = check_flash(gen, dev)
        check_tiny_rules()
        tiny_entries = check_tiny(gen, dev)
    with torch.no_grad():
        check_flash_bwd_rules()
        flash_bwd_entries = check_flash_bwd(gen, dev)
        tiny_bwd_entries = check_tiny_bwd(gen, dev)
        t_tiled = time.perf_counter()
        tiled_entries = check_tiny_tiled(gen, dev, TILED_MAIN_SHAPES, TILED_MAIN_SHAPES_16)
        log(f"key-tiled tiny checks: {time.perf_counter() - t_tiled:.1f} s")
    torch.cuda.empty_cache()

    # ---- the main path: X2VLM-base retrieval serving at full width ----
    cfg = XVLMConfig.base()
    t0 = time.perf_counter()
    model = XVLMForRetrieval(cfg, dtype=torch.bfloat16, device=dev, seed=args.seed)
    server = RetrievalServer(model)
    res = cfg.vision.image_res
    images = torch.randint(0, 256, (BATCH, res, res, 3), generator=gen,
                           device=dev).to(torch.uint8)
    ids = torch.randint(1, cfg.text.vocab_size, (BATCH, TEXT_LEN), generator=gen,
                        device=dev)
    lens = torch.randint(5, TEXT_LEN + 1, (BATCH,), generator=gen, device=dev)
    lens[0] = TEXT_LEN
    atts = (torch.arange(TEXT_LEN, device=dev)[None] < lens[:, None]).to(torch.int32)
    ids = ids * atts
    requests = (images, ids, atts)
    torch.cuda.synchronize()
    log(f"model: X2VLM-base 224px, {sum(p.numel() for p in model.parameters())} "
        f"params, built in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    outs, per_request, by_shape = serve(server, *requests)
    check_round("bf16", cfg, outs, per_request, want_launches(cfg, quant=False))
    check_tiny_routes("bf16 serving", {"tiny_attention_fwd": dict(by_shape["tiny_route"])})
    check_flash_fwd_routes("bf16 serving", dict(by_shape["flash_route"]), cfg.vision.depth)
    req_ms = time_requests(server, requests, outs)
    log(f"request ms (B={BATCH}, CUDA events, median of 5): "
        f"{json.dumps({k: round(v, 3) for k, v in req_ms.items()})}")
    log(f"throughput: images/s {BATCH / req_ms['encode_images'] * 1e3:.1f}, "
        f"texts/s {BATCH / req_ms['encode_texts'] * 1e3:.1f}, "
        f"itm pairs/s {BATCH / req_ms['itm_score'] * 1e3:.1f}, encode pairs/s "
        f"{BATCH / (req_ms['encode_images'] + req_ms['encode_texts']) * 1e3:.1f}")
    profile_round(args, smi, server, requests, "chip_smoke_profile.txt")

    # ---- the same weights on the port's CPU path, fp32, 2 rows ----
    state = model.state_dict()
    cpu_state = {k: v.cpu() for k, v in state.items()}
    against_cpu("card bf16", cfg, cpu_state, outs, requests)
    del server, model, outs
    torch.cuda.empty_cache()

    # ---- the int8 serving path, the same weights ----
    with torch.inference_mode():
        int8_gemm_entries, int8_quant_entries = check_int8(gen, dev)
    torch.cuda.empty_cache()
    q_per_request, q_by_shape = int8_phase(args, dev, state, cpu_state, requests, smi)
    del state, cpu_state
    torch.cuda.empty_cache()

    # ---- the second main path: X2VLM-base pretraining steps ----
    train = train_phase(args, dev, gen, smi)

    # ---- phases 7 and 8: the launcher's pretrain and retrieval tasks ----
    with root_dir as root:
        try:
            th_path, tok_dir, words, pre_counts = pretrain_launcher_phase(
                root, args.seed, dev, args, smi, pretrain_data)
        except BaseException:
            if "ddp" in PHASE7:   # phase 24's rank, waiting for this phase
                PHASE7["ddp"].cleanup()
            raise
        torch.cuda.empty_cache()
        # ---- phase 24: phase 7's run under torchrun (NCCL, world 1), hdfs:// ----
        try:
            ddp_counts = ddp_launcher_phase(PHASE7["ddp"], smi)
        finally:
            PHASE7["ddp"].cleanup()
            PHASE7.clear()
        ret_counts = retrieval_launcher_phase(args, root, th_path, tok_dir, words, dev, smi)
        torch.cuda.empty_cache()
        # ---- phase 19: X2VLM-large 1B pretraining at its own sizes ----
        # (here, while the holds' worker has no hold queued: its image call
        # peaks at ~74 GiB of the card's 80, and a hold's card pass beside it
        # would not fit)
        large_tok = large_tok_dir(root, tok_dir)
        l1b_work = work_dir(root, 16 * 2**30)
        try:
            l1b_counts = large_1b_phase(args, root, large_tok, words, l1b_work, dev, smi)
        finally:
            if l1b_work != root:
                shutil.rmtree(l1b_work, ignore_errors=True)
        torch.cuda.empty_cache()
        # ---- phase 9: the launcher's grounding and NLVR2 fine-tunes ----
        ft_counts = finetune_launcher_phase(args, root, th_path, tok_dir, words,
                                            os.path.join(root, "flickr"), dev, smi)
        torch.cuda.empty_cache()
        # ---- phase 10: the launcher's VQA fine-tune at 768 px ----
        vqa_counts = vqa_launcher_phase(args, root, th_path, tok_dir, words,
                                        os.path.join(root, "flickr"), dev, smi)
        torch.cuda.empty_cache()
        # ---- phase 16: X2VLM-large pretraining through the launcher, remat held ----
        # ---- phase 17: VQA on X2VLM-large at 768 px, accumulate_steps 2, remat dots ----
        # ---- phase 20: stage-2 large video pretraining from phase 16's .th ----
        # (here, so that their CPU fp32 holds, the slowest, run in the worker
        # beside phases 11-15; their states leave RAM before phase 11, the
        # holds keep the parameters only)
        large_work = work_dir(root, 24 * 2**30)
        try:
            large_pre_counts, large_tok, large_th = large_pretrain_phase(
                args, root, tok_dir, large_work, dev, smi)
            torch.cuda.empty_cache()
            large_vqa_counts = large_vqa_phase(args, root, large_th, large_tok, words,
                                               os.path.join(root, "flickr"), large_work, dev,
                                               smi)
            torch.cuda.empty_cache()
            s2l_counts = large_stage2_phase(args, root, large_tok, words, large_th, large_work,
                                            dev, smi)
            torch.cuda.empty_cache()
            # ---- phase 22: refcoco_grounding_large.yaml from phase 16's .th ----
            # ---- phase 23: coco_captioning_large.yaml from phase 16's .th ----
            lg_counts = large_ft_phase(args, "grounding", root, large_th, large_tok, words,
                                       os.path.join(root, "flickr"), large_work, dev, smi)
            torch.cuda.empty_cache()
            lc_counts = large_ft_phase(args, "captioning", root, large_th, large_tok, words,
                                       os.path.join(root, "flickr"), large_work, dev, smi)
        finally:
            if large_work != root:
                shutil.rmtree(large_work, ignore_errors=True)
        torch.cuda.empty_cache()
        # ---- phase 11: the launcher's captioning fine-tune, eval and SCST ----
        cap_counts = caption_launcher_phase(args, root, th_path, tok_dir, words,
                                            os.path.join(root, "flickr"), dev, smi)
        torch.cuda.empty_cache()
        # ---- phase 12: the launcher's retrieval task on CLIP ViT and Swin ----
        tower_counts = tower_launcher_phase(args, root, tok_dir, os.path.join(root, "flickr"),
                                            os.path.join(root, "flickr_test.json"), requests,
                                            dev, smi)
        torch.cuda.empty_cache()
        # ---- phase 13: the video path (stage-2 video pretraining, video QA) ----
        t13 = time.perf_counter()
        video_counts = video_launcher_phase(args, root, th_path, tok_dir, words, dev, smi)
        log(f"phase 13 seconds: {time.perf_counter() - t13:.1f}")
        torch.cuda.empty_cache()
        # ---- phase 18: X2VLM-base 1B pretraining (the aux stream) at its own sizes ----
        b1b_work = work_dir(root, 8 * 2**30)
        try:
            b1b_counts = base_1b_phase(args, root, tok_dir, words, b1b_work, dev, smi)
        finally:
            if b1b_work != root:
                shutil.rmtree(b1b_work, ignore_errors=True)
        torch.cuda.empty_cache()
        # ---- phase 14: the Plus / CCLM base, the multilingual and parallel-text streams ----
        # ---- phase 15: the IGLUE tasks on phase 14's Plus state ----
        plus_work = work_dir(root, 40 * 2**30)
        try:
            cclm_counts, plus = cclm_launcher_phase(args, root, th_path, words, plus_work, dev,
                                                    smi)
            torch.cuda.empty_cache()
            # ---- phase 21: CCLM-large (code-switched regions) at its own sizes ----
            cl_counts = cclm_large_phase(args, root, plus_work, plus["tok_dir"], words, dev,
                                         smi)
            torch.cuda.empty_cache()
            iglue_counts = iglue_launcher_phase(args, root, plus, words, plus_work, dev, smi)
            # the deferred holds read states under root and plus_work
            collect_holds()
        finally:
            if plus_work != root:
                shutil.rmtree(plus_work, ignore_errors=True)
    torch.cuda.empty_cache()

    # the attention launches of the main paths (bf16 serving requests, one
    # train step, int8 serving requests, the launcher's tasks) by kernel,
    # operands and shape; each entry of the kernels line takes those of its
    # checked shape, and a launch at a shape no check held fails the run
    ledger = collections.Counter()
    for path, c in (("serving", by_shape), ("int8_serving", q_by_shape)):
        ledger_add(ledger, path, "serving", {"tiny_fwd": c["tiny"],
                                             "flash_fwd_shapes": c["flash"]})
    ledger_add(ledger, "train_step", "training", train)
    ledger_add(ledger, "pretrain_launcher", "training", pre_counts)
    ledger_add(ledger, "ddp_launcher", "training", ddp_counts)
    ledger_add(ledger, "cclm_launcher", "training", cclm_counts)
    ledger_add(ledger, "large_pretrain_launcher", "training", large_pre_counts, LARGE_HEADS)
    for operands, c in large_vqa_counts.items():
        ledger_add(ledger, "large_vqa_launcher", operands, c, LARGE_HEADS)
    ledger_add(ledger, "base_1b_launcher", "training", b1b_counts)
    ledger_add(ledger, "large_1b_launcher", "training", l1b_counts, LARGE_HEADS)
    ledger_add(ledger, "large_stage2_launcher", "training", s2l_counts, LARGE_HEADS)
    for path, split in (("large_grounding_launcher", lg_counts),
                        ("large_caption_launcher", lc_counts)):
        for operands, c in split.items():
            ledger_add(ledger, path, operands, c, LARGE_HEADS)
    # CCLM-large: its vision tower at 16 heads, XLM-R and the cross encoder at 12
    ledger_add(ledger, "cclm_large_launcher", "training",
               {k: cl_counts[k] for k in LEDGER_PARTS if k.startswith("flash")}, LARGE_HEADS)
    ledger_add(ledger, "cclm_large_launcher", "training",
               {k: cl_counts[k] for k in ("tiny_fwd", "tiny_bwd")})
    for path, split in (("retrieval_launcher", ret_counts), ("finetune_launcher", ft_counts),
                        ("vqa_launcher", vqa_counts), ("caption_launcher", cap_counts[0]),
                        ("caption_launcher", cap_counts[1]), ("video_launcher", video_counts),
                        ("iglue_launcher", iglue_counts)):
        for operands, c in split.items():
            ledger_add(ledger, path, operands, c)
    for tower, r in tower_counts.items():
        for operands, c in r["run"].items():
            ledger_add(ledger, f"{tower}_launcher", operands, c)
        ledger_add(ledger, f"{tower}_launcher", "serving", r["requests"])

    kernels = attention_kernels(ledger, flash_entries + tiny_entries + flash_bwd_entries +
                                tiny_bwd_entries, tiled_entries)
    for entries, counter in ((int8_gemm_entries, "int8_matmul"),
                             (int8_quant_entries, "int8_quantize")):
        for e in entries:   # the int8 serving path only, by (M, K, N) / (M, K)
            n = q_by_shape[counter][e["key"]]
            kernels.append(dict({k: v for k, v in e.items() if k != "key"}, launches=n,
                                launches_by_path={p: n if p == "int8_serving" else 0
                                                  for p in PATHS}))
    for e in kernels:
        if e["launches"] == 0:
            fail(f"{e['name']} ({e['shape']}) was not launched on the main path")
    log(f"seconds: {time.perf_counter() - t_start:.1f}")
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} failure(s): {FAILURES}")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
