"""VQA evaluation by ranking the answer list (the port's counterpart of
x2vlm_tpu/tasks/vqa.py; reference VQA.py:66-116)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from x2vlm_tpu_torch.tasks.finetune import padded_batches

__all__ = ["evaluate_vqa"]


@torch.inference_mode()
def evaluate_vqa(model, dataset, answer_list: List[str], answer_ids: np.ndarray,
                 answer_atts: np.ndarray, *, device, k_test: int = 128,
                 batch_size: int = 32, host_id: int = 0, num_hosts: int = 1) -> List[Dict]:
    """[{question_id, answer}] for rank ``host_id``'s share of ``dataset``'s lines: each
    question's best answer of ``model.predict`` over the tokenised answer
    list, the ``min(k_test, len(answer_list))`` best first-token answers
    reranked. Each call has ``batch_size`` questions, the last padded with
    copies of its last."""
    model.eval()
    k = min(k_test, len(answer_list))
    ans_ids = torch.as_tensor(answer_ids).long().to(device)
    ans_atts = torch.as_tensor(answer_atts).to(device)
    results: List[Dict] = []
    for samples, rows in padded_batches(dataset, batch_size, host_id, num_hosts):
        batch = {key: torch.from_numpy(np.stack([s[key] for s in rows])).to(device)
                 for key in ("image", "question_ids", "question_atts")}
        batch["question_ids"] = batch["question_ids"].long()
        batch.update(answer_ids=ans_ids, answer_atts=ans_atts)
        topk_ids, _ = model.predict(batch, k)
        best = topk_ids[:, 0].cpu().numpy()
        for j, s in enumerate(samples):
            results.append({"question_id": int(s["question_id"]),
                            "answer": answer_list[int(best[j])]})
    return results
