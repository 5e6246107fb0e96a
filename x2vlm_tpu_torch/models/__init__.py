from x2vlm_tpu_torch.models.beit2 import BEiT2, BEiT2Config
from x2vlm_tpu_torch.models.bert import BertConfig, BertEncoder
from x2vlm_tpu_torch.models.captioning import XVLMForMLMCaptioning
from x2vlm_tpu_torch.models.classification import (
    XVLMForClassification, XVLMForMultipleChoice, XVLMForNLVR,
)
from x2vlm_tpu_torch.models.clip_vit import CLIPViT, CLIPViTConfig
from x2vlm_tpu_torch.models.generation import XVLMForVQA
from x2vlm_tpu_torch.models.grounding import XVLMForGrounding
from x2vlm_tpu_torch.models.heads import XVLMForPretrain, XVLMForRetrieval
from x2vlm_tpu_torch.models.resampler import PerceiverResampler
from x2vlm_tpu_torch.models.swin import SwinConfig, SwinTransformer
from x2vlm_tpu_torch.models.vit import ViT, ViTConfig
from x2vlm_tpu_torch.models.xvlm import (
    MlpHead, XVLMBase, XVLMConfig, build_vision_tower, vision_seq_len, vision_width,
)
from x2vlm_tpu_torch.models.xvlm_plus import (
    XVLMPlusConfig, XVLMPlusForPretrain, split_params_to_plus,
)

__all__ = ["BEiT2", "BEiT2Config", "BertConfig", "BertEncoder", "CLIPViT", "CLIPViTConfig",
           "MlpHead", "PerceiverResampler", "SwinConfig", "SwinTransformer", "ViT",
           "ViTConfig", "XVLMBase", "XVLMConfig", "XVLMForClassification", "XVLMForGrounding",
           "XVLMForMLMCaptioning", "XVLMForMultipleChoice", "XVLMForNLVR", "XVLMForPretrain",
           "XVLMForRetrieval", "XVLMForVQA", "XVLMPlusConfig", "XVLMPlusForPretrain",
           "build_vision_tower", "split_params_to_plus", "vision_seq_len", "vision_width"]
