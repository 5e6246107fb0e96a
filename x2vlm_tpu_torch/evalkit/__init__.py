from x2vlm_tpu_torch.evalkit.grounding import (
    cxcywh_norm_to_xyxy_pixels, grounding_eval_bbox, grounding_eval_bbox_vlue, iou_xyxy,
)

__all__ = ["cxcywh_norm_to_xyxy_pixels", "grounding_eval_bbox", "grounding_eval_bbox_vlue",
           "iou_xyxy"]
