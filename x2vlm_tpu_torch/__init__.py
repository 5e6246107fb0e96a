"""PyTorch + CUDA (Hopper, sm_90a) port of the X2-VLM framework.

The JAX package ``x2vlm_tpu`` beside this one is the reference: the same
reference-named weights go into both, and the outputs must agree. This
package imports ``torch``, ``numpy`` and the standard library only; where it
needs something of the JAX package it keeps its own copy.

Slice 1 covers the retrieval serving path (``models.heads.XVLMForRetrieval``
behind ``serving.RetrievalServer``): BEiT-2 image encode, BERT text encode
and the ITM rerank head. Slice 2 covers the pretraining step
(``models.heads.XVLMForPretrain``: ITC + ITM with hard negatives + MLM;
``train.create_optimizer`` / ``train.make_train_step``). Attention runs in
hand-written CUDA kernels, forward and backward (``ops/flash_attention.py``,
``ops/tiny_attention.py``). Slice 3 adds int8 W8A8 serving
(``ops/int8_matmul.py``). Slice 4 adds the launcher for the ``pretrain`` and
``retrieval`` tasks (``python -m x2vlm_tpu_torch.run``) with what it
needs: configs and their key registry (``core/``), the BERT WordPiece
tokenizer, image decode and transforms, the data streams and datasets
(``data/``), the model factory (``factory.py``), the reference ``.th``
import and save / resume (``train/checkpoint.py``), the multi-stream step
(``train/trainer.py``) and the tasks' loops (``tasks/``). Later slices add
the region stream, the grounding, NLVR2, VQA and captioning tasks, the CLIP
ViT / Swin / ViT towers with the export CLI, and the video path (5-D frame
batches through ``XVLMBase.get_frame_embeds``: the stage-2 video stream,
video QA, NExT-QA multiple choice and video retrieval).

Entry points run on the card unless the caller passes ``device="cpu"``
(see ``device.resolve_device``).
"""

from x2vlm_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
