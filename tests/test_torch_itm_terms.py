"""``chip_smoke.itm_term_faults``, phase 19's hold of the ITM head's first
weight term by term, on the CPU with a tiny pretraining model.

- The model in bf16 against itself in fp32: every term holds (the fused
  CLS features, each call's p - y, each row's gradient before the sum, the
  summed gradient against the terms' scale), and the fp32 terms add up to
  the weight gradient.
- A fault planted in the ITM head's input on the pass under test (two
  rows' features swapped, one row's features zeroed or moved by 20% noise)
  fails the hold, as ``tools/fusion384_faults.py`` plants faults for the
  40 x 584 hold on the card; so does a fault in the weight gradient the
  bf16 pass applied (zeroed, halved).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForPretrain,
)

CONFIG = XVLMConfig(
    vision=BEiT2Config(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                       drop_path_rate=0.0, dropout_rate=0.0),
    text=BertConfig(vocab_size=64, hidden_size=32, num_layers=4, fusion_layer=2, num_heads=2,
                    intermediate_size=64, encoder_width=32, hidden_dropout=0.0,
                    attn_dropout=0.0, max_position_embeddings=16),
    embed_dim=16)
B, L = 3, 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(19)
    ids = rng.integers(5, 64, (B, L))
    atts = np.ones((B, L), np.int64)
    atts[1, 5:] = 0
    return {"image": torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3)).astype(np.uint8)),
            "text_ids": torch.from_numpy(ids * atts),
            "text_atts": torch.from_numpy(atts),
            "text_ids_masked": torch.from_numpy(np.where(rng.random((B, L)) < 0.3, 3, ids) * atts),
            "masked_pos": torch.from_numpy(rng.integers(1, 5, (B, 2))),
            "masked_ids": torch.from_numpy(rng.integers(5, 64, (B, 2)))}


def _pass(state, dtype, fault=None):
    """The ITM head's recorded calls and its first weight's gradient, two
    image batches through the model in ``dtype``; ``fault`` edits the head's
    input."""
    model = XVLMForPretrain(CONFIG, dtype=dtype, device="cpu", seed=None)
    model.load_state_dict(state)
    if fault is not None:
        head, orig = model.base.itm_head, model.base.itm_head.forward
        head.forward = lambda x: orig(fault(x))
    neg = (torch.tensor([1, 2, 0]), torch.tensor([2, 0, 1]))
    calls = []
    with chip_smoke.itm_head_terms(model, calls):
        loss = sum(model(_batch(), neg_idx=neg).values())
        loss = loss + sum(model(_batch(), neg_idx=neg[::-1]).values())
        loss.backward()
    grad = dict(model.named_parameters())[chip_smoke.ITM_HEAD_WEIGHT].grad.detach()
    return calls, grad.double().reshape(-1)


@pytest.fixture(scope="module")
def reference():
    state = XVLMForPretrain(CONFIG, dtype=torch.float32, device="cpu", seed=7).state_dict()
    return state, _pass(state, torch.float32)


@pytest.fixture(scope="module")
def bf16_pass(reference):
    return _pass(reference[0], torch.bfloat16)


def test_bf16_pass_holds_term_by_term(reference, bf16_pass):
    _, (cpu, cpu_grad) = reference
    card, card_grad = bf16_pass
    readings, faults = chip_smoke.itm_term_faults(cpu, card, cpu_grad, card_grad)
    assert faults == []
    assert readings["rows"] == 2 * 3 * B
    assert readings["min_feature_cos"] >= 0.99 and readings["min_row_grad_cos"] >= 0.99
    assert readings["applied_over_call_sums"] <= chip_smoke.ITM_APPLIED_LIMIT
    assert readings["summed_dist_over_scale"] <= chip_smoke.ITM_SUM_LIMIT


def test_the_terms_add_up_to_the_weight_gradient(reference):
    _, (cpu, cpu_grad) = reference
    terms = sum(torch.einsum("ro,ri->oi", c["delta"], c["x"]) for c in cpu)
    np.testing.assert_allclose(terms.reshape(-1).numpy(), cpu_grad.numpy(), rtol=1e-5,
                               atol=1e-7)


def _swap(x):
    x = x.clone()
    x[[0, 1]] = x[[1, 0]]
    return x


def _zero(x):
    x = x.clone()
    x[2] = 0
    return x


def _noise(x):
    g = torch.Generator().manual_seed(3)
    noise = torch.zeros_like(x)
    noise[1] = 0.2 * x[1].detach().norm() / x.shape[1] ** 0.5 * torch.randn(
        x.shape[1], generator=g)
    return x + noise


@pytest.mark.parametrize("fault", [_swap, _zero, _noise], ids=["swap", "zero", "noise"])
def test_a_fault_in_the_head_input_fails(reference, fault):
    state, (cpu, cpu_grad) = reference
    card, card_grad = _pass(state, torch.float32, fault)
    _, faults = chip_smoke.itm_term_faults(cpu, card, cpu_grad, card_grad)
    assert faults, "the planted fault passed the hold"


@pytest.mark.parametrize("scale", [0.0, 0.5], ids=["zeroed", "halved"])
def test_a_fault_in_the_applied_gradient_fails(reference, bf16_pass, scale):
    """The bf16 pass's terms as recorded, the weight gradient it applied
    zeroed or halved: the applied hold and the summed hold each fail."""
    _, (cpu, cpu_grad) = reference
    card, card_grad = bf16_pass
    _, faults = chip_smoke.itm_term_faults(cpu, card, cpu_grad, scale * card_grad)
    assert any("applied gradient" in f for f in faults), faults
    assert any("summed gradient" in f for f in faults), faults


def _cancelling_calls(noise: float):
    """Two calls of 8 rows whose gradient terms nearly cancel, as the ITM
    rows' p - y do at trained weights: rows in pairs with close features
    and opposite p - y. ``noise`` moves each element of the features, the
    upstream gradient and p - y by that relative amount, as a bf16 pass
    does; the applied gradient is the terms summed, rounded to bf16 once a
    call."""
    g = torch.Generator().manual_seed(5)
    randn = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)
    calls, noisy, grad, noisy_grad = [], [], 0, 0
    for _ in range(2):
        x = randn(8, 32)
        x[1::2] = x[0::2] + 0.125 * randn(4, 32)
        c = torch.rand(8, generator=g, dtype=torch.float64) + 0.5
        c[1::2] = -c[0::2]
        delta = c[:, None] * randn(16)[None]
        call = {"x": x, "delta": delta, "dlogits": torch.stack([-c, c], 1)}
        moved = {k: v * (1 + noise * randn(*v.shape)) for k, v in call.items()}
        calls.append(call)
        noisy.append(moved)
        grad = grad + torch.einsum("ro,ri->oi", delta, x)
        noisy_grad = noisy_grad + torch.einsum(
            "ro,ri->oi", moved["delta"], moved["x"]).to(torch.bfloat16).double()
    return calls, noisy, grad.reshape(-1), noisy_grad.reshape(-1)


@pytest.mark.parametrize("scale", [1.0, 0.0, 0.5], ids=["held", "zeroed", "halved"])
def test_the_summed_holds_where_the_terms_cancel(scale):
    """Where the terms cancel to a tenth of their scale, a pass off by bf16
    rounding holds; its applied gradient zeroed fails the applied and the
    summed hold, halved the applied hold (the sum then reads 0.049 of the
    scale, under the summed limit)."""
    cpu, card, cpu_grad, card_grad = _cancelling_calls(2 ** -8)
    readings, faults = chip_smoke.itm_term_faults(cpu, card, cpu_grad, scale * card_grad)
    assert 0.08 < readings["summed_norm_over_terms"] < 0.12   # --seed 1 on the card: 0.0975
    if scale == 1.0:
        assert faults == []
        return
    assert any("applied gradient" in f for f in faults), faults
    assert any("summed gradient" in f for f in faults) == (scale == 0.0), faults
