"""The IGLUE task models on the Plus / CCLM base against the JAX package, in
fp32 on the CPU, and the launcher's six IGLUE tasks.

- ``XVLMForNLVR`` (MARVL), ``XVLMForClassification`` (XVNLI), ``XVLMForVQA``
  (xGQA: the RoBERTa-form decoder, ``loss_vqa``, ``rank_answer``) and
  ``XVLMForRetrieval`` at 80 tokens (WIT, xFlickrCO; its text and fusion
  attention on the plain core, as the JAX dispatch runs it) on an
  ``XVLMPlusConfig``: outputs, losses and every parameter's gradient
  against the JAX heads, the JAX parameters carried across by
  ``convert.py``;
- the rank pass in chunks of rows equal to the one-shot pass bit for bit;
- the decoder's parameters from the Plus base's cross encoder, and the
  RoBERTa-form decoder names through the JAX ``.th`` import;
- ``python -m x2vlm_tpu_torch.run`` on the five shipped IGLUE configs (and
  ``xretrieval``) with a tiny model on written data: a step and an eval
  each, xGQA's ``--resume`` bit for bit, XVNLI under ``--fewshot``.

Config: tests/test_torch_plus.py's tiny Plus base (an XLM-R-form text tower
of 2 layers and a vocabulary of 60, 2 cross layers, BEiT-2 of width 32 at
32 px, every dropout at 0) with 96 positions. Tolerances: forward
``rtol = atol = 1e-5``, gradients ``1e-4``, as tests/test_torch_plus.py."""

import base64
import dataclasses
import io
import json
import re

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)
from PIL import Image

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_plus import FWD, GRAD, TEXT, VISION, _noisy  # noqa: E402
from tests.test_torch_xlmr_tokenizer import write_xlmr_dir  # noqa: E402
from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMForClassification as JaxXVLMForClassification, XVLMForNLVR as JaxXVLMForNLVR,
    XVLMForRetrieval as JaxXVLMForRetrieval, XVLMForVQA as JaxXVLMForVQA,
)
from x2vlm_tpu.models.generation import (  # noqa: E402
    decoder_params_from_text_encoder as jax_decoder_params,
)
from x2vlm_tpu.models.xvlm_plus import XVLMPlusConfig as JaxXVLMPlusConfig  # noqa: E402
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from x2vlm_tpu_torch import run  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params, to_jax_params  # noqa: E402
from x2vlm_tpu_torch.core.config import load_config  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import build_tokenizer  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMForClassification, XVLMForNLVR, XVLMForRetrieval,
    XVLMForVQA, XVLMPlusConfig, XVLMPlusForPretrain,
)
from x2vlm_tpu_torch.models import generation  # noqa: E402
from x2vlm_tpu_torch.models.generation import (  # noqa: E402
    decoder_params_from_text_encoder, rank_chunk_rows, sample_generate,
)
from x2vlm_tpu_torch.ops import layers as port_layers  # noqa: E402
from x2vlm_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402

RES, B, L, LONG, N_DEC = 32, 3, 8, 80, 2
# XLM-R's specials: <s> 0 (the answers' BOS), <pad> 1, </s> 2; answers 1 / 2
# and 3 / 4 share their first token, so the first stage ties them
ANSWERS = np.array([[0, 10, 2, 1, 1], [0, 11, 12, 2, 1], [0, 11, 2, 1, 1],
                    [0, 13, 14, 15, 2], [0, 13, 2, 1, 1], [0, 16, 2, 1, 1]], np.int32)


def _text(cls):
    return dataclasses.replace(cls.roberta_base(**TEXT), max_position_embeddings=LONG + 16)


def _jax_config():
    return JaxXVLMPlusConfig(vision=JaxBEiT2Config(**VISION), text=_text(JaxBertConfig),
                             embed_dim=16, num_cross_layers=2)


def _port_config():
    return XVLMPlusConfig(vision=BEiT2Config(**VISION), text=_text(BertConfig), embed_dim=16,
                          num_cross_layers=2)


def _rows(rng, n, length):
    """XLM-R-style rows: <s> first, <pad> (1) after each row's length."""
    ids = rng.integers(4, 60, (n, length)).astype(np.int32)
    ids[:, 0] = 0
    atts = np.ones((n, length), np.int32)
    atts[1, length - 3:] = 0
    atts[n - 1, length // 2:] = 0
    return np.where(atts == 1, ids, 1).astype(np.int32), atts


def _init(model, batch, noise_rng, **kw):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jb,
                      **kw)
    return _noisy(init, noise_rng)


def _to_port(variables, model):
    state, unused = convert_jax_params(_flatten(variables), device="cpu")
    assert unused == [] and set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


def _tb(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 and not k.endswith("atts")
            else torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads(port, jax_grads):
    want, _ = convert_jax_params(_flatten({"params": jax_grads}), device="cpu")
    for name, p in port.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD)


def _loss_and_grads(model, variables, batch, key, port, **call):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        return model.apply({"params": params}, jb, deterministic=True, **call)[key]

    want, grads = jax.value_and_grad(loss)(variables["params"])
    port.zero_grad(set_to_none=True)
    got = port(_tb(batch))
    got[key].backward()
    np.testing.assert_allclose(got[key].item(), float(want), **FWD)
    _assert_grads(port, grads)
    port.zero_grad(set_to_none=True)


# ---- MARVL (NLVR2 heads) and XVNLI (3-way classification) ----

@pytest.fixture(scope="module")
def nlvr():
    rng = np.random.default_rng(20)
    ids, atts = _rows(rng, B, L)
    batch = {"image0": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "image1": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "text_ids": ids, "text_atts": atts, "labels": np.array([0, 1, 1], np.int32)}
    model = JaxXVLMForNLVR(_jax_config(), dtype=jnp.float32)
    variables = _init(model, batch, rng)
    port = _to_port(variables, XVLMForNLVR(_port_config(), dtype=torch.float32, device="cpu",
                                           seed=None))
    return model, variables, batch, port


def test_nlvr_on_the_plus_base_equals_jax(nlvr):
    """Two fusion passes through the cross encoder: the state dict is the
    converted JAX tree (``cross_encoder``, XLM-R's ``text_encoder.roberta``,
    a top-level ``cls_head``), the logits, ``loss_cls`` and every
    gradient."""
    model, variables, batch, port = nlvr
    assert set(variables["params"]["base"]) == {"temp", "vision_encoder", "text_encoder",
                                                "cross_encoder"}
    assert {k.split(".")[0] for k in port.state_dict()} == {
        "temp", "vision_encoder", "text_encoder", "cross_encoder", "cls_head"}
    want = model.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                       method=JaxXVLMForNLVR.predict)
    with torch.no_grad():
        got = port.predict(_tb(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    _loss_and_grads(model, variables, batch, "loss_cls", port)


@pytest.fixture(scope="module")
def xvnli():
    rng = np.random.default_rng(21)
    ids, atts = _rows(rng, B, L)
    batch = {"image": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "text_ids": ids, "text_atts": atts, "labels": np.array([2, 0, 1], np.int32)}
    model = JaxXVLMForClassification(_jax_config(), num_labels=3, dtype=jnp.float32)
    variables = _init(model, batch, rng)
    port = _to_port(variables, XVLMForClassification(_port_config(), num_labels=3,
                                                     dtype=torch.float32, device="cpu",
                                                     seed=None))
    return model, variables, batch, port


def test_xvnli_classification_on_the_plus_base_equals_jax(xvnli):
    model, variables, batch, port = xvnli
    want = model.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                       method=JaxXVLMForClassification.predict)
    with torch.no_grad():
        got = port.predict(_tb(batch))
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    _loss_and_grads(model, variables, batch, "loss_cls", port)


# ---- xGQA (the VQA decoder in the RoBERTa form) ----

@pytest.fixture(scope="module")
def vqa():
    rng = np.random.default_rng(22)
    q_ids, q_atts = _rows(rng, B, L)
    a_ids = ANSWERS[[0, 1, 3, 2, 5]]
    batch = {"image": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "question_ids": q_ids, "question_atts": q_atts,
             "answer_ids": a_ids, "answer_atts": (a_ids != 1).astype(np.int32),
             "answer_weights": np.array([0.5, 0.3, 1.0, 0.0, 0.7], np.float32),
             "answer_index": np.array([0, 0, 1, 2, 2], np.int32)}
    model = JaxXVLMForVQA(_jax_config(), num_dec_layers=N_DEC, pad_token_id=1,
                          dtype=jnp.float32)
    variables = _init(model, batch, rng)
    port = _to_port(variables, XVLMForVQA(_port_config(), num_dec_layers=N_DEC,
                                          pad_token_id=1, dtype=torch.float32, device="cpu",
                                          seed=None))
    return model, variables, batch, port


def _pred(batch):
    return {"image": batch["image"], "question_ids": batch["question_ids"],
            "question_atts": batch["question_atts"], "answer_ids": ANSWERS,
            "answer_atts": (ANSWERS != 1).astype(np.int32)}


def test_the_vqa_decoder_takes_the_roberta_names(vqa):
    """``text_decoder.roberta.*`` (a cross-attention in every layer) and the
    tied head ``text_decoder.lm_head.{dense, layer_norm, bias}``; a seeded
    model carries the same tree."""
    _, variables, _, port = vqa
    assert set(variables["params"]) == {"base", "text_decoder", "dec_head"}
    state = port.state_dict()
    for j in range(N_DEC):
        assert f"text_decoder.roberta.encoder.layer.{j}.crossattention.self.key.weight" in state
    assert {k for k in state if k.startswith("text_decoder.lm_head.")} == {
        "text_decoder.lm_head.dense.weight", "text_decoder.lm_head.dense.bias",
        "text_decoder.lm_head.layer_norm.weight", "text_decoder.lm_head.layer_norm.bias",
        "text_decoder.lm_head.bias"}
    assert not any(".bert." in k or ".cls." in k for k in state)
    fresh = XVLMForVQA(_port_config(), num_dec_layers=N_DEC, pad_token_id=1,
                       dtype=torch.float32, device="cpu", seed=0)
    assert set(fresh.state_dict()) == set(state)


def test_decode_logits_and_rank_answer_run_on_the_plus_base(vqa):
    """The task model's reaches into the answer decoder go through its
    form-agnostic ``.stack`` / ``.mlm_head`` (a RoBERTa-form decoder has no
    ``.bert``): ``decode_logits``, ``predict`` and ``sample_generate``
    equal to JAX where JAX has them, finite where it has no counterpart
    input (the sampler's draws)."""
    model, variables, batch, port = vqa
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_states = model.apply(variables, jb["image"], jb["question_ids"], jb["question_atts"],
                              method=JaxXVLMForVQA.encode_question)
    idx = batch["answer_index"]
    want = model.apply(variables, jb["answer_ids"], jb["answer_atts"], want_states[idx],
                       jb["question_atts"][idx], method=JaxXVLMForVQA.decode_logits)
    t = _tb(batch)
    with torch.no_grad():
        states = port.encode_question(t["image"], t["question_ids"], t["question_atts"])
        logits = port.decode_logits(t["answer_ids"], t["answer_atts"], states[idx],
                                    t["question_atts"][idx])
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states), **FWD)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **FWD)
    out = sample_generate(port, _tb(_pred(batch)), max_length=4, bos_token_id=0,
                          eos_token_id=2, pad_token_id=1, greedy=True)
    assert out.shape == (B, 4) and ((out >= 0) & (out < 60)).all()


def test_loss_vqa_and_gradients_on_the_plus_base_equal_jax(vqa):
    model, variables, batch, port = vqa
    _loss_and_grads(model, variables, batch, "loss_vqa", port)


@pytest.mark.parametrize("k", [4, len(ANSWERS)])
def test_rank_answer_on_the_plus_base_equals_jax(vqa, k):
    model, variables, batch, port = vqa
    pred = _pred(batch)
    want_ids, want_probs = model.apply(variables, {k_: jnp.asarray(v) for k_, v in pred.items()},
                                       k, method=JaxXVLMForVQA.predict)
    with torch.no_grad():
        ids, probs = port.predict(_tb(pred), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), **FWD)


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_rank_answer_in_chunks_equals_the_one_shot_pass(vqa, monkeypatch, rows):
    """The Q x k = 12 reranked rows decoded ``rows`` at a time (8: a chunk
    of 8 and one of 4) give the one-shot pass's answers and probabilities
    bit for bit: each row's loss reads its own row only."""
    _, _, batch, port = vqa
    pred = _tb(_pred(batch))
    with torch.no_grad():
        want = port.predict(pred, 4)
    assert rank_chunk_rows(ANSWERS.shape[1], 60) >= B * 4     # the default: one chunk
    monkeypatch.setattr(generation, "RANK_CHUNK_BYTES", rows * 2 * 4 * ANSWERS.shape[1] * 60)
    assert rank_chunk_rows(ANSWERS.shape[1], 60) == rows
    calls = []
    decode = port.decode_logits
    monkeypatch.setattr(port, "decode_logits",
                        lambda ids, *a: calls.append(ids.shape[0]) or decode(ids, *a))
    with torch.no_grad():
        got = port.predict(pred, 4)
    assert calls == [B] + [rows] * (B * 4 // rows) + ([B * 4 % rows] if B * 4 % rows else [])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rank_chunk_rows_at_the_shipped_vocabularies():
    """4,096 rows at BERT's 30,522 (VQAv2's whole rank pass, Q = 32 x k =
    128, one chunk), 512 at XLM-R's 250,002 (xGQA's: 8 chunks); each
    chunk's fp32 logits and log-probabilities within the budget."""
    assert rank_chunk_rows(10, 30522) == 4096
    assert rank_chunk_rows(10, 250002) == 512
    assert 512 * 10 * 250002 * 8 <= generation.RANK_CHUNK_BYTES < 1024 * 10 * 250002 * 8


def _nested(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = re.sub(r"^params/(base/)?", "", k).split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("num_dec", [2, 1])
def test_decoder_params_from_the_plus_cross_encoder(num_dec):
    """On the Plus base the decoder's layers come from the cross encoder
    (layer j, or 2 j + 1 for half as many), its embeddings from XLM-R's and
    its head from the ``lm_head``, under the RoBERTa names: the JAX
    function's result on the fused view of the same weights (the text
    tower's layers, then the cross encoder's)."""
    state = XVLMPlusForPretrain(_port_config(), dtype=torch.float32, device="cpu",
                                seed=5).base.state_dict()
    got = decoder_params_from_text_encoder(state, num_text_layers=2, num_cross_layers=2,
                                           num_dec_layers=num_dec)
    base = _nested(to_jax_params(state))
    fused = dict(base, text_encoder=dict(base["text_encoder"], **{
        f"layer_{2 + j}": base["cross_encoder"][f"layer_{j}"] for j in range(2)}))
    want_tree = jax_decoder_params(fused, num_text_layers=2, num_cross_layers=2,
                                   num_dec_layers=num_dec)
    want, _ = convert_jax_params(_flatten(dict(want_tree, text_encoder=base["text_encoder"])),
                                 device="cpu")
    want = {k: v for k, v in want.items() if k.startswith("text_decoder.")}
    assert set(got) == set(want)
    assert any(k.startswith("text_decoder.lm_head.") for k in got)
    assert any(k.startswith(f"text_decoder.roberta.encoder.layer.{num_dec - 1}.") for k in got)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_the_roberta_decoder_round_trips_through_the_jax_th_import(vqa):
    """A fine-tuned xGQA ``.th`` with the decoder's head in the form the JAX
    import reads (``text_decoder.lm_head.transform.*`` and its tied decoder
    weight): the JAX tree and the port's import of it equal the model's
    weights bit for bit; the port's own names load back with nothing left
    over."""
    _, _, _, port = vqa
    state = {k: v + 0.01 for k, v in port.state_dict().items()}
    jax_form = (("text_decoder.lm_head.dense.", "text_decoder.lm_head.transform.dense."),
                ("text_decoder.lm_head.layer_norm.", "text_decoder.lm_head.transform.LayerNorm."))
    sd = {}
    for k, v in state.items():
        for ours, theirs in jax_form:
            k = k.replace(ours, theirs)
        sd[k] = v
    sd["text_decoder.lm_head.decoder.weight"] = \
        state["text_decoder.roberta.embeddings.word_embeddings.weight"]
    tree, _ = jax_ckpt.convert_xvlm_state_dict({k: v.numpy() for k, v in sd.items()},
                                               vision_depth=2)
    assert set(tree["dec_head"]) == {"transform_dense", "transform_ln", "decoder",
                                     "decoder_bias"}
    tree["dec_head"].pop("decoder")      # the tied table
    got = {re.sub(r"^params/(base/)?", "", k): v for k, v in to_jax_params(state).items()}
    want = {k: np.asarray(v, np.float32) for k, v in _flatten(tree).items()}
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    for file in (sd, state):
        fresh = XVLMForVQA(_port_config(), num_dec_layers=N_DEC, pad_token_id=1,
                           dtype=torch.float32, device="cpu", seed=0)
        missing, unexpected = ckpt_lib.load_reference_checkpoint(fresh, file)
        assert missing == []
        assert unexpected == (["text_decoder.lm_head.decoder.weight"] if file is sd else [])
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, state[k]), k


# ---- WIT / xFlickrCO (retrieval at 80 tokens) ----

class _Routes:
    """Counts ``MultiHeadAttention``'s calls by route, each still running
    what it wraps."""

    def __init__(self, monkeypatch):
        self.calls = {"tiny": 0, "flash": 0, "plain": 0}
        for route, name in (("tiny", "tiny_block_attention"), ("flash", "flash_attention"),
                            ("plain", "dot_product_attention")):
            fn = getattr(port_layers, name)

            def counted(*a, _fn=fn, _route=route, **kw):
                self.calls[_route] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(port_layers, name, counted)


def test_retrieval_at_80_tokens_on_the_plus_base_equals_jax(monkeypatch):
    """ITC and ITM (the JAX hard negatives injected) at WIT's and
    xFlickrCO's 80 tokens, losses and every gradient; at 80 queries no call
    takes the tiny kernel (the JAX rule's Sq <= 64): XLM-R's self-attention
    and the cross encoder's run the plain core, as the JAX package runs
    them in XLA. At 40 tokens the same model's text calls take the tiny
    kernel."""
    rng = np.random.default_rng(23)
    ids, atts = _rows(rng, B, LONG)
    batch = {"image": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "text_ids": ids, "text_atts": atts, "idx": np.array([4, 8, 4], np.int32)}
    model = JaxXVLMForRetrieval(_jax_config(), dtype=jnp.float32)
    key = jax.random.PRNGKey(3)
    variables = _init(model, batch, rng, rng=key)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def negs(m, b, key):
        ie, _ = m.base.get_vision_embeds(b["image"])
        te = m.base.get_text_embeds(b["text_ids"], b["text_atts"])
        return m.base.get_hard_negatives(*m.base.get_features(ie, te), key, idx=b["idx"])

    def losses(params):
        out = model.apply({"params": params}, jb, rng=key, deterministic=True)
        return jnp.stack([out["loss_itc"], out["loss_itm"]])

    want, vjp = jax.vjp(losses, variables["params"])
    (want_grads,) = vjp(jnp.ones(2, jnp.float32))
    neg = tuple(torch.from_numpy(np.array(x)).long()
                for x in model.apply(variables, jb, key, method=negs))
    port = _to_port(variables, XVLMForRetrieval(_port_config(), dtype=torch.float32,
                                                device="cpu", seed=None))
    routes = _Routes(monkeypatch)
    got = port({k: torch.from_numpy(v) for k, v in batch.items()}, neg_idx=neg)
    assert routes.calls["tiny"] == 0 and routes.calls["plain"] > 0
    (got["loss_itc"] + got["loss_itm"]).backward()
    np.testing.assert_allclose([got["loss_itc"].item(), got["loss_itm"].item()],
                               np.asarray(want), **FWD)
    _assert_grads(port, want_grads)
    short = {k: torch.from_numpy(v) for k, v in batch.items()}
    short.update(text_ids=short["text_ids"][:, :40], text_atts=short["text_atts"][:, :40])
    with torch.no_grad():
        port(short, neg_idx=neg)
    assert routes.calls["tiny"] == 2 + 2 * 2     # XLM-R's 2 layers; the cross encoder's 2 x 2


# ---- the launcher on the shipped IGLUE configs ----

CONFIGS = {"xvnli": "xvnli_cclm_base.yaml", "marvl": "marvl_cclm_base.yaml",
           "xgqa": "xgqa_cclm_base.yaml", "wit": "wit_cclm_base.yaml",
           "xflickrco": "xflickrco_cclm_base.yaml", "xretrieval": "xflickrco_cclm_base.yaml"}
LANGS = ("de", "zh")
WORDS = {"en": "a dog runs over the river bank small red house".split(),
         "de": "der hund läuft über den fluss kleines rotes haus".split(),
         "zh": list("一只狗在河边奔跑小红房子")}


def _cap(rng, lang, n=6):
    ws = WORDS[lang]
    return ("" if lang == "zh" else " ").join(ws[i] for i in rng.integers(0, len(ws), n))


def _png(rng):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n" for r in rows))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Each task's train lines (English) and ``{lang: path}`` test lines."""
    d = tmp_path_factory.mktemp("iglue_launcher")
    xlmr = write_xlmr_dir(d)
    rng = np.random.default_rng(0)
    (d / "imgs").mkdir()
    for i in range(6):
        (d / "imgs" / f"im{i}.png").write_bytes(_png(rng))
        (d / "imgs" / f"{100 + i}.jpg").write_bytes(_png(rng))
    labels = ("contradiction", "entailment", "neutral")
    for lang in ("en",) + LANGS:
        _jsonl(d / f"wit_{lang}.jsonl", [
            {"image_content": base64.b64encode(_png(rng)).decode(), "image_url": "u",
             "caption_reference_description": _cap(rng, lang, 30)} for _ in range(4)])
        _jsonl(d / f"xflickrco_{lang}.jsonl", [
            {"id": i, "img_path": f"im{i}.png", "sentences": [_cap(rng, lang, 30)]}
            for i in range(4)])
        _jsonl(d / f"xvnli_{lang}.jsonl", [
            {"Flikr30kID": str(100 + i), "sentence2": _cap(rng, lang),
             "gold_label": labels[i % 3]} for i in range(4)])
        _jsonl(d / f"marvl_{lang}.jsonl", [
            {"left_img": f"im{i}.png", "right_img": f"im{i + 1}.png", "caption": _cap(rng, lang),
             "label": bool(i % 2)} for i in range(4)])
        (d / f"gqa_{lang}.json").write_text(json.dumps(
            [{"image": f"im{i}.png", "question": _cap(rng, lang), "question_id": i,
              "answer": _cap(rng, "en", 1)} for i in range(4)], ensure_ascii=False))
        (d / f"xre_{lang}.json").write_text(json.dumps(
            [{"image": f"im{i}.png", "caption": [_cap(rng, lang, 30)]} for i in range(4)],
            ensure_ascii=False))
    _jsonl(d / "xvnli_de_4.jsonl", [json.loads(x) for x in
                                     (d / "xvnli_de.jsonl").read_text().splitlines()])
    (d / "nlvr.json").write_text(json.dumps(
        [{"images": [f"im{i}.png", f"im{i + 2}.png"], "sentence": _cap(rng, "en"),
          "label": "True" if i % 2 else "False"} for i in range(4)]))
    (d / "answers.json").write_text(json.dumps(sorted({*(WORDS["en"])}), ensure_ascii=False))
    return d, xlmr


def _shipped(corpus, task, **extra):
    """The task's shipped config, its data paths pointed at the corpus, a
    tiny model, batch 4 (one step an epoch), k_test 4."""
    d, xlmr = corpus
    cfg = load_config(f"configs/finetune/{CONFIGS[task]}").to_dict()
    assert cfg["model_type"] == "cclm" and cfg["image_res"] == 384
    del cfg["vision_config"]
    per_lang = lambda stem, ext="jsonl": {lang: str(d / f"{stem}_{lang}.{ext}")  # noqa: E731
                                          for lang in LANGS}
    data = {"xvnli": dict(train_file=[str(d / "xvnli_en.jsonl")], test_file=per_lang("xvnli"),
                          image_root=str(d / "imgs")),
            "marvl": dict(train_file=[str(d / "nlvr.json")],
                          test_file=dict(per_lang("marvl"), en=str(d / "nlvr.json")),
                          image_root=str(d / "imgs"), marvl_image_root=str(d / "imgs")),
            "xgqa": dict(train_file=[str(d / "gqa_en.json")],
                         test_file=per_lang("gqa", "json"), vqa_root=str(d / "imgs"),
                         answer_list=str(d / "answers.json"), num_dec_layers=2),
            "wit": dict(train_file=[str(d / "wit_en.jsonl")], test_file=per_lang("wit")),
            "xflickrco": dict(train_file=[str(d / "xflickrco_en.jsonl")],
                              test_file=per_lang("xflickrco"), image_root=str(d / "imgs")),
            "xretrieval": dict(train_file=[str(d / "xre_en.json")],
                               test_file=per_lang("xre", "json"), image_root=str(d / "imgs"))}
    cfg.update(
        data[task], image_res=RES, text_encoder=xlmr,
        vision_config_inline={"vision_width": 32, "patch_size": 16, "num_hidden_layers": 2,
                              "num_attention_heads": 2},
        text_num_hidden_layers=2, text_fusion_start_at=2, num_cross_layers=2,
        text_config_inline={"vocab_size": len(build_tokenizer(xlmr).get_vocab()),
                            "hidden_size": 32, "num_heads": 2, "intermediate_size": 64,
                            "max_position_embeddings": LONG + 16},
        embed_dim=16, batch_size=4, batch_size_test=4, k_test=4,
        schedular=dict(cfg["schedular"], epochs=1))
    cfg.update(extra)
    return cfg


def _main(corpus, task, name, cfg, *extra):
    d = corpus[0]
    path = d / f"cfg_{name}.json"
    path.write_text(json.dumps(cfg, ensure_ascii=False))
    return run.main(["--task", task, "--config", str(path), "--output_dir",
                     str(d / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _state(corpus, name):
    return torch.load(corpus[0] / f"out_{name}" / "ckpt" / ckpt_lib.TRAIN_STATE_FILE,
                      weights_only=False)


METRIC = {"xvnli": ("loss_cls", "accuracy"), "marvl": ("loss_cls", "accuracy"),
          "xgqa": ("loss_vqa", "acc"), "wit": ("loss_itm", "r_mean"),
          "xflickrco": ("loss_itm", "r_mean"), "xretrieval": ("loss_itm", "r_mean")}


@pytest.mark.parametrize("task", list(CONFIGS))
def test_the_launcher_runs_each_iglue_task(corpus, task):
    """One step and the eval over the ``{lang: path}`` test sets: a finite
    loss, each language's metric and their mean; the Plus base trained (a
    cross encoder and XLM-R in the state); MARVL's ``en`` set is NLVR2's;
    xGQA writes a result file a language."""
    loss, metric = METRIC[task]
    rec = _main(corpus, task, task, _shipped(corpus, task))
    langs = LANGS + (("en",) if task == "marvl" else ())
    assert np.isfinite(rec[loss]) and rec["epoch"] == 0
    for lang in langs:
        assert np.isfinite(rec[f"eval_{lang}_{metric}"]), lang
    assert rec[f"eval_{metric}"] == pytest.approx(
        np.mean([rec[f"eval_{lang}_{metric}"] for lang in langs]))
    state = _state(corpus, task)
    assert state["step"] == 1
    assert any(k.startswith("cross_encoder.") for k in state["params"])
    assert any(k.startswith("text_encoder.roberta.") for k in state["params"])
    if task == "xgqa":
        for lang in LANGS:
            results = json.loads((corpus[0] / "out_xgqa" / f"vqa_result_{lang}.json")
                                 .read_text())
            assert sorted(r["question_id"] for r in results) == [0, 1, 2, 3]


def test_xgqa_resumes_exactly(corpus, monkeypatch):
    """2 epochs of one step, the state saved after the first kept: a
    ``--resume`` from it reads the whole run's second batch and ends in its
    state (parameters, AdamW moments, count) bit for bit."""
    cfg = _shipped(corpus, "xgqa", schedular=dict(_shipped(corpus, "xgqa")["schedular"],
                                                  epochs=2))
    batches = {}
    to_device = run.to_device
    save = ckpt_lib.save_train_state

    def spy(name):
        def fn(batch, device):
            batches.setdefault(name, []).append({k: np.array(v) for k, v in batch.items()})
            return to_device(batch, device)
        return fn

    def keep_step1(ckpt_dir, model, optimizer, step, data_state=None):
        path = save(ckpt_dir, model, optimizer, step, data_state)
        if step == 1 and ckpt_dir.endswith("out_gqa_whole/ckpt"):
            save(str(corpus[0] / "out_gqa_resumed" / "ckpt"), model, optimizer, step,
                 data_state)
        return path

    monkeypatch.setattr(run, "to_device", spy("whole"))
    monkeypatch.setattr(ckpt_lib, "save_train_state", keep_step1)
    _main(corpus, "xgqa", "gqa_whole", cfg)
    monkeypatch.setattr(run, "to_device", spy("resumed"))
    _main(corpus, "xgqa", "gqa_resumed", cfg, "--resume")
    assert len(batches["whole"]) == 2 and len(batches["resumed"]) == 1
    for k, v in batches["whole"][1].items():
        np.testing.assert_array_equal(batches["resumed"][0][k], v, err_msg=k)
    whole, resumed = _state(corpus, "gqa_whole"), _state(corpus, "gqa_resumed")
    assert whole["step"] == resumed["step"] == whole["count"] == resumed["count"] == 2
    for part in ("params", "mu", "nu"):
        for k, v in whole[part].items():
            assert torch.equal(resumed[part][k], v), (part, k)


def test_xvnli_fewshot_and_classification_through_the_launcher(corpus):
    """``--fewshot de,4``: a two-slot train template takes both parts, a
    one-slot test template the language alone; and ``--task
    classification`` with ``dataset_type: xvnli`` runs the same task, its
    3-label head from ``num_labels``."""
    d = corpus[0]
    cfg = _shipped(corpus, "xvnli", train_file=[str(d / "xvnli_{}_{}.jsonl")],
                   test_file=str(d / "xvnli_{}.jsonl"))
    rec = _main(corpus, "xvnli", "xvnli_few", cfg, "--fewshot", "de,4")
    assert np.isfinite(rec["loss_cls"]) and rec["eval_n"] == 4
    saved = json.loads((d / "out_xvnli_few" / "config.json").read_text())
    assert saved["train_file"] == [str(d / "xvnli_de_4.jsonl")]
    assert saved["test_file"] == str(d / "xvnli_de.jsonl")
    rec = _main(corpus, "classification", "xvnli_cls", _shipped(corpus, "xvnli"))
    assert np.isfinite(rec["loss_cls"]) and np.isfinite(rec["eval_accuracy"])
    assert _state(corpus, "xvnli_cls")["params"]["cls_head.3.weight"].shape[0] == 3


def test_an_iglue_task_starts_from_a_cclm_pretraining_state(corpus):
    """``--checkpoint <dir>`` holding a CCLM pretraining train state (its
    ``base.`` core): the core's parameters load into the task model, its
    head stays fresh (returned for the lr_mult group); the same task's
    state loads strictly."""
    d = corpus[0]
    cfg = _shipped(corpus, "xvnli")
    pre, _ = run.build_model(cfg, "pretrain", device="cpu", dtype=torch.float32, seed=3)
    assert isinstance(pre, XVLMPlusForPretrain)
    ck = d / "pre_ckpt"
    ck.mkdir()
    torch.save({"params": {n: p.detach() for n, p in pre.named_parameters()}, "step": 5},
               ck / ckpt_lib.TRAIN_STATE_FILE)
    args = run.parse_args(["--task", "xvnli", "--config", "x", "--output_dir", str(d / "o"),
                           "--checkpoint", str(ck), "--device", "cpu"])
    model, _ = run.build_model(cfg, "classification", device="cpu", dtype=torch.float32)
    missing = run.load_initial_params(args, cfg, model)
    assert missing == sorted(n for n, _ in model.named_parameters() if n.startswith("cls_head."))
    want = dict(pre.named_parameters())
    for n, p in model.named_parameters():
        if not n.startswith("cls_head."):
            assert torch.equal(p, want["base." + n]), n
    torch.save({"params": {n: p.detach() + 1 for n, p in model.named_parameters()}, "step": 6},
               ck / ckpt_lib.TRAIN_STATE_FILE)
    fresh_head = model.cls_head[0].weight.detach().clone()
    assert run.load_initial_params(args, cfg, model) == []
    assert torch.equal(model.cls_head[0].weight, fresh_head + 1)
