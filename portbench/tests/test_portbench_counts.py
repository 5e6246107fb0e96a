"""CPU tests of the benchmark's yardstick: the roofline arithmetic against
bounds the port's kernel table records, the FLOP counts against the
reference's matmuls counted by ``FlopCounterMode``, the seeded weights
against the program's parameters, name for name and shape for shape."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))

from portbench.drivers.pretrain import model_block  # noqa: E402
from portbench.lib import flops, roofline  # noqa: E402
from portbench.lib.weights import make_weights  # noqa: E402
from portbench.reference.x2vlm import Reference, param_spec  # noqa: E402


def meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_k1_bound_at_h12_b128_s197_is_the_recorded_one():
    B, H, S, D = 128, 12, 197, 64
    q = meta((B, H, S, D))
    b, f = roofline.flash_fwd(q, q, q, bias=meta((1, H, S, S)))
    ms, by = roofline.bound_ms(b, f)
    assert by == "bytes" and round(ms, 4) == 0.0469


def test_key_tiled_k5_bound_at_b32_40x584_serving_is_the_recorded_one():
    q, kv = meta((32, 40, 768)), meta((32, 584, 768))
    b, f = roofline.tiny_fwd(q, kv, kv, 12, key_mask=meta((32, 584), torch.int8))
    ms, by = roofline.bound_ms(b, f)
    assert by == "bytes" and round(ms, 4) == 0.0183


def test_flash_backward_bounds_are_the_recorded_ones():
    """PR 19's table: H12 B128 S197, K2 / K3 / K4 bounds 0.0588 / 0.0704 /
    0.0478 ms (bytes)."""
    B, H, S, D = 128, 12, 197, 64
    q = meta((B, H, S, D))
    got = roofline.flash_bwd(q, q, q, bias=meta((1, H, S, S)))
    assert [round(roofline.bound_ms(*got[k])[0], 4) for k in ("dq", "dkv", "dbias")] == \
        [0.0588, 0.0704, 0.0478]


TINY = {
    "vision": {"width": 32, "depth": 2, "heads": 2, "patch_size": 16, "mlp_ratio": 4.0,
               "ln_eps": 1e-6, "drop_path_rate": 0.1, "image_res": 48},
    "text": {"vocab": 500, "hidden": 32, "layers": 3, "fusion_layer": 2, "heads": 2,
             "intermediate": 64, "max_positions": 64, "type_vocab": 2, "ln_eps": 1e-12,
             "hidden_dropout": 0.1, "attn_dropout": 0.1},
    "embed_dim": 16,
}


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@torch.no_grad()
def test_flop_counts_equal_the_reference_matmuls():
    P = make_weights(param_spec(TINY, "pretrain"), 3, "cpu")
    ref = Reference(P, TINY)
    v, t = TINY["vision"], TINY["text"]
    img = torch.randn(3, 48, 48, 3)
    assert counted(lambda: ref.vision(img)) == flops.vision_fwd(v, 3)
    ids = torch.randint(1, 500, (5, 7))
    atts = torch.ones(5, 7, dtype=torch.int32)
    assert counted(lambda: ref.text(ids, atts)) == flops.text_fwd(t, 5, 7)
    S_img = (48 // 16) ** 2 + 1
    image = torch.randn(2, S_img, 32)
    gather = torch.tensor([0, 1, 1, 0, 1])
    # the reference pads the image keys to a multiple of 8; the count takes
    # the unpadded keys, so compare with the padded length
    padded = S_img + (-S_img) % 8
    got = counted(lambda: ref.fusion(torch.randn(5, 7, 32), atts, image,
                                     torch.ones(5, S_img, dtype=torch.int32), gather=gather))
    assert got == flops.fusion_fwd(t, v, 5, 7, 2, padded)


@pytest.mark.parametrize("name,heads", [("x2vlm_base", "pretrain"), ("x2vlm_large", "pretrain"),
                                        ("x2vlm_base", "retrieval")])
def test_the_weights_fill_every_parameter_of_the_program(name, heads):
    """The reference's spec at the configuration's widths names every
    parameter of the launcher's model with its shape (meta tensors: no
    full-size weights are made here)."""
    from x2vlm_tpu_torch.factory import build_model

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    res = 224 if heads == "pretrain" else 384
    model, _ = build_model({**cfg["yaml"], "image_res": res}, heads, device="meta",
                           seed=None)
    prefix = "base." if heads == "pretrain" else ""
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    m = model_block(cfg, {"image_res": res})
    got = {prefix + n: shape for n, shape, _ in param_spec(m, heads)}
    assert got == want
