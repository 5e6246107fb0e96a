"""``chip_smoke``'s hold of 13d (video retrieval) and 13e (NExT-QA multiple
choice through the Perceiver resampler) on the CPU, with tiny models of
both families built from the shipped ``vqa_msrvtt_base.yaml``.

- The model in bf16 against itself in fp32 holds: the losses, the head's
  outputs, the losses' gradients at their outputs (p - y) and at the
  parameters (term by term by the head's rows where only they reach), and
  the gradients of the VJP of seeded cotangents on those outputs; the
  CPU's row terms add up to its loss gradients.
- A fault planted in the fusion cross-attention (``ops.tiny_attention``) of
  the pass under test fails the hold: in the forward, the output of the
  first query tile lost (an eighth of the queries, at least the CLS row);
  in the backward, dk written to the keys in reverse order (a tile index
  walked the wrong way; the last keys may be padding). The backward fault
  leaves the losses, the outputs and p - y as they were: the VJP's
  gradients and the losses' own fail. The weights are drawn from a seed
  with the cross-attention's output projection scaled up 20 times, so that
  the fused features depend on it as they do at trained weights (at the
  drawn scale a forward fault moves the ITM logits by 1e-4).
"""

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.factory import build_model  # noqa: E402
from x2vlm_tpu_torch.ops import tiny_attention  # noqa: E402

RES, F, L, VOCAB, K = 32, 3, 10, 64, 5
TINY = dict(
    image_res=RES, frame_len=F,
    vision_config_inline={"vision_width": 32, "patch_size": 16, "num_hidden_layers": 2,
                          "num_attention_heads": 2},
    text_num_hidden_layers=4, text_fusion_start_at=2,
    text_config_inline={"vocab_size": VOCAB, "hidden_size": 32, "num_heads": 2,
                        "intermediate_size": 64, "max_position_embeddings": 64},
    embed_dim=16, max_tokens=L)
TASKS = {"retrieval": ("video_retrieval", {}),
         "multiple_choice": ("next_qa_mc", {"video_encoding": "resampler"})}
SEED = 17   # the cotangents' seed


def _cfg(family):
    cfg = load_config("configs/finetune/vqa_msrvtt_base.yaml").to_dict()
    del cfg["vision_config"]
    cfg.update(TINY, **TASKS[family][1])
    return cfg


def _batch(family):
    rng = np.random.default_rng(13)
    frames = torch.from_numpy(rng.integers(0, 256, (2, F, RES, RES, 3)).astype(np.uint8))
    shape = (2, L) if family == "retrieval" else (2, K, L)
    atts = np.ones(shape, np.int64)
    atts[..., 7:] = 0
    ids = torch.from_numpy(rng.integers(5, VOCAB, shape) * atts)
    if family == "retrieval":
        return {"image": frames, "text_ids": ids, "text_atts": torch.from_numpy(atts),
                "idx": torch.tensor([0, 1])}
    return {"image": frames, "option_ids": ids, "option_atts": torch.from_numpy(atts),
            "labels": torch.tensor([3, 1])}


def _pass(family, state, dtype):
    cfg = _cfg(family)
    names, term_names = chip_smoke.video_task_names(TASKS[family][0], cfg)
    return chip_smoke.iglue_pass(family, state, cfg, _batch(family), torch.device("cpu"), dtype,
                                 names=names, cotangent_seed=SEED, term_names=term_names)


def _compare(family, cpu, card):
    return chip_smoke.iglue_compare(family, cpu, card, ([], []), n_calls=0)


@pytest.fixture(scope="module", params=list(TASKS))
def reference(request):
    family = request.param
    state = build_model(_cfg(family), family, device="cpu", dtype=torch.float32,
                        seed=3)[0].state_dict()
    for k, v in state.items():
        if "crossattention.output.dense.weight" in k:
            v.mul_(20.0)
    return family, state, _pass(family, state, torch.float32)


def test_bf16_pass_holds(reference):
    family, state, cpu = reference
    readings, faults = _compare(family, cpu, _pass(family, state, torch.bfloat16))
    assert faults == []
    rows = 3 * 2 if family == "retrieval" else 2 * K
    names, term_names = chip_smoke.video_task_names(TASKS[family][0], _cfg(family))
    assert set(readings["loss_cosine"]) == set(names)
    assert set(readings["row_terms"]) == set(term_names) and len(term_names) >= 4
    for r in readings["row_terms"].values():
        # the norm of a sum over its terms' root-sum-square: at most sqrt(rows)
        assert r["rows"] == rows and 0.0 < r["sum_over_rss"] <= rows ** 0.5


def _query_tile_lost(fired):
    fwd = tiny_attention.tiny_attention_fwd

    def faulty(q, k, *a, **kw):
        out, probs = fwd(q, k, *a, **kw)
        if k.shape[1] != q.shape[1]:
            fired.append(1)
            out = out.clone()
            out[:, :max(1, q.shape[1] // 8)] = 0
        return out, probs

    return "tiny_attention_fwd", faulty


def _dk_reversed(fired):
    bwd = tiny_attention.tiny_attention_bwd

    def faulty(q, k, *a, **kw):
        dq, dk, dv = bwd(q, k, *a, **kw)
        if k.shape[1] != q.shape[1]:
            fired.append(1)
            dk = dk.flip(1)
        return dq, dk, dv

    return "tiny_attention_bwd", faulty


def test_a_forward_fault_in_the_cross_attention_fails(reference, monkeypatch):
    """More than the losses and the outputs fail: p - y, the head's terms
    or the VJP's gradients."""
    family, state, cpu = reference
    fired = []
    monkeypatch.setattr(tiny_attention, *_query_tile_lost(fired))
    _, faults = _compare(family, cpu, _pass(family, state, torch.float32))
    assert fired, "the fault was not planted: no cross-attention call"
    assert [f for f in faults if not f.startswith(("loss_", "card outputs"))], faults


def test_a_backward_fault_in_the_cross_attention_fails(reference, monkeypatch):
    family, state, cpu = reference
    fired = []
    monkeypatch.setattr(tiny_attention, *_dk_reversed(fired))
    readings, faults = _compare(family, cpu, _pass(family, state, torch.float32))
    assert fired, "the fault was not planted: no cross-attention call"
    # nothing but the gradients moved: the VJP's and the key weight's terms fail
    key = next(k for k in readings["row_terms"] if "crossattention.self.key" in k)
    assert any(f.startswith("gradient ") for f in faults), faults
    assert any(f.startswith(f"{key}: a row's") for f in faults), faults
    assert not [f for f in faults if f.startswith(("loss_", "card outputs", "the losses'"))]
    assert min(readings["dloss_cosine"]) > 1 - 1e-9
