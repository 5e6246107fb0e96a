from x2vlm_tpu_torch.evalkit.caption import (
    bleu, caption_eval, cider_d, meteor, porter_stem, rouge_l,
)
from x2vlm_tpu_torch.evalkit.grounding import (
    cxcywh_norm_to_xyxy_pixels, grounding_eval_bbox, grounding_eval_bbox_vlue,
    grounding_eval_vlue, iou_xyxy,
)
from x2vlm_tpu_torch.evalkit.refer import grounding_eval_mask, mask_iou, rle_decode
from x2vlm_tpu_torch.evalkit.vqa import (
    exact_match_accuracy, normalize_answer, vqa_accuracy, vqa_eval,
)

__all__ = ["bleu", "caption_eval", "cider_d", "meteor", "porter_stem", "rouge_l",
           "cxcywh_norm_to_xyxy_pixels", "exact_match_accuracy", "grounding_eval_bbox",
           "grounding_eval_bbox_vlue", "grounding_eval_mask", "grounding_eval_vlue",
           "iou_xyxy", "mask_iou", "rle_decode", "normalize_answer", "vqa_accuracy",
           "vqa_eval"]
