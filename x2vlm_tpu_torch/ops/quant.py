"""Dynamic W8A8 int8 quantization for the serving path (counterpart of
x2vlm_tpu/ops/quant.py).

Scheme, as in the JAX package: weights get symmetric per-output-channel
scales from their abs-max, quantized on the fly from the fp32 parameters
(checkpoints stay unchanged); activations get symmetric per-token scales
from their abs-max at run time (no calibration pass); the product
accumulates in int32 and is dequantized with the outer product of the two
scales (``ops/int8_matmul.py``).

:func:`qdense` plays the part of ``QDense.__call__``: it takes an
``nn.Linear``'s own ``weight`` / ``bias``, so a model built with
``quant_int8=True`` has exactly the parameters, names and state dict of the
float model, and either loads the other's weights. Callers that feed
several projections from one input (q/k/v) quantize it once with
:func:`quantize_act` and pass the pair through. Serving only: ``round`` has
no gradient, and the int8 layers raise in training mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from x2vlm_tpu_torch.ops.int8_matmul import int8_matmul, int8_scale, quantize_act

__all__ = ["qdense", "quantize_act", "quantize_weight"]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (N, K) ``nn.Linear`` weight -> (int8 (N, K), fp32 scales (N,)),
    symmetric per output channel (the JAX ``quantize_weight`` takes the
    (K, N) kernel and returns scales (1, N))."""
    wf = w.float()
    sw = int8_scale(wf.abs().amax(dim=1))
    return torch.round(wf / sw[:, None]).to(torch.int8), sw


def qdense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, xq: Optional[torch.Tensor] = None, sx: Optional[torch.Tensor] = None,
           act: Optional[str] = None, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 ``x @ weight.T + bias`` (then ``act``) in ``dtype``: the weight
    is quantized per output channel, x per token (or ``(xq, sx)`` from
    :func:`quantize_act` is used), the fp32 bias is added to the fp32
    dequantized sum before the activation and the cast."""
    wq, sw = quantize_weight(weight)
    return int8_matmul(x, wq, sw, bias, act=act, out_dtype=dtype, xq=xq, sx=sx)
