"""The captioning model against the JAX package in fp32 on the CPU:
``XVLMForMLMCaptioning`` (its parameter names equal the converted JAX
tree), ``loss_caption`` in the standard and the FG-free encodings and
``loss_scst``, with every parameter's gradient, against
``jax.value_and_grad``; ``decode_step`` with the static cache against the
JAX one and against a full forward; both beam searches against the JAX
token lists (a case with tied logits, one with n-gram blocking, one with
a length penalty); ``_trace_back``; ``sample_generate_captioning`` and
the VQA ``sample_generate`` with the JAX draws injected;
``top_k_top_p_filtering`` and ``label_smoothing_loss``; and the route of
the masked and cached self-attentions (the plain core, never a kernel).

Config: test_torch_grounding.py's (32 px, 2 vision blocks, a 2 + 2 layer
text stack of width 32), dropout off. Tolerances: losses and logits to
1e-5, gradients to rtol = atol = 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_grounding import (  # noqa: E402
    BOXES, RES, VOCAB, assert_grads_equal, jax_config, port_config, to_port,
)
from tests.test_torch_pretrain import _noisy  # noqa: E402
from x2vlm_tpu.models import captioning as jcap  # noqa: E402
from x2vlm_tpu.models import generation as jgen  # noqa: E402
from x2vlm_tpu.tasks.scst import _encode_row  # noqa: E402
from x2vlm_tpu_torch.models import XVLMForMLMCaptioning, XVLMForVQA  # noqa: E402
from x2vlm_tpu_torch.models import captioning as pcap  # noqa: E402
from x2vlm_tpu_torch.models import generation as pgen  # noqa: E402
from x2vlm_tpu_torch.ops import layers as port_layers  # noqa: E402
from x2vlm_tpu_torch.ops.attention import dot_product_attention  # noqa: E402

CLS, SEP, MASK = 2, 3, 4
B, L, M = 3, 10, 4
PROMPT = [CLS, 5, 13]          # [CLS] a the
SEARCH = dict(mask_token_id=MASK, eos_token_id=SEP, num_beams=3, min_length=2, max_length=6)


def _standard_batch(rng, n=B):
    """The standard UniLM encoding: tril attention, positions 0..L-1, a few
    [MASK] slots (one row with a pad slot, one whose target is CLS)."""
    ids = rng.integers(5, len(VOCAB), (n, L)).astype(np.int32)
    ids[:, 0] = CLS
    masked_pos = np.zeros((n, M), np.int32)
    masked_ids = np.full((n, M), -100, np.int32)
    weight = np.zeros((n, M), np.float32)
    for b in range(n):
        k = M if b else M - 1
        pos = np.sort(rng.choice(np.arange(1, L - 1), k, replace=False))
        masked_pos[b, :k], masked_ids[b, :k], weight[b, :k] = pos, ids[b, pos], 1.0
        ids[b, pos] = MASK
    masked_ids[n - 1, 0] = CLS
    return {"text_ids_masked": ids, "text_atts_matrix": np.tile(np.tril(np.ones((L, L),
                                                                                np.int32)),
                                                                (n, 1, 1)),
            "position_ids": np.tile(np.arange(L, dtype=np.int32), (n, 1)),
            "masked_pos": masked_pos, "masked_ids": masked_ids, "masked_weight": weight}


def _fg_free_batch(captions, max_length=4):
    """The FG-free encoding the SCST step trains on (duplicated positions, a
    column-masked tril), with an over-long caption whose last slots fall
    past the row."""
    rows = [_encode_row(c, PROMPT, mask_token_id=MASK, sep_token_id=SEP, pad_token_id=0,
                        L=len(PROMPT) + 2 * (max_length + 1), max_masks=max_length + 1)
            for c in captions]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


CAPTIONS = [[10, 11, 12], [20, 21, 22, 23, 24, 25], [7]]


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def cap():
    rng = np.random.default_rng(3)
    model = jcap.XVLMForMLMCaptioning(jax_config(), label_smoothing=0.1, cls_token_id=CLS,
                                      dtype=jnp.float32)
    images = rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
    batch = dict(_standard_batch(rng), image=images)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      jb(batch))
    variables = _noisy(init, rng)
    port = to_port(variables, XVLMForMLMCaptioning(port_config(), label_smoothing=0.1,
                                                   cls_token_id=CLS, dtype=torch.float32,
                                                   device="cpu", seed=None))
    return dict(model=model, variables=variables, batch=batch, port=port, images=images)


def test_parameter_names_are_the_converted_jax_tree(cap):
    """base/{vision_encoder, text_encoder, mlm_head}: no projections, temp,
    ITM or bbox head; the MLM head under text_encoder.cls.predictions."""
    params = cap["variables"]["params"]
    assert set(params) == {"base"}
    assert set(params["base"]) == {"vision_encoder", "text_encoder", "mlm_head"}
    state = cap["port"].state_dict()
    assert {k.split(".")[0] for k in state} == {"vision_encoder", "text_encoder"}
    assert "text_encoder.cls.predictions.transform.dense.weight" in state
    fresh = XVLMForMLMCaptioning(port_config(), dtype=torch.float32, device="cpu", seed=0)
    assert set(fresh.state_dict()) == set(state)


def _loss_case(cap, case):
    if case == "standard":
        return cap["batch"], "loss_caption"
    batch = dict(_fg_free_batch(CAPTIONS), image=cap["images"])
    if case == "scst":
        batch["sample_weights"] = np.array([0.7, -1.2, 0.4], np.float32)
        return batch, "loss_scst"
    return batch, "loss_caption"


@pytest.mark.parametrize("case", ["standard", "fg_free", "scst"])
def test_losses_and_gradients_equal_jax(cap, case):
    """``loss_caption`` (label smoothing 0.1; a pad slot and a CLS target
    ignored) in both encodings and ``loss_scst`` (advantage-weighted, an
    over-long row's clamped slots at weight 0), each with every gradient."""
    model, variables = cap["model"], cap["variables"]
    batch, key = _loss_case(cap, case)

    def loss(params):
        return model.apply({"params": params}, jb(batch), deterministic=True)[key]

    want, want_grads = jax.value_and_grad(loss)(variables["params"])
    port = cap["port"]
    port.zero_grad(set_to_none=True)
    port.train()
    try:
        got = port(tb(batch))
        assert tuple(got) == (key,)
        got[key].backward()
    finally:
        port.eval()
    np.testing.assert_allclose(got[key].item(), float(want), **BOXES)
    assert_grads_equal(port, want_grads)


def _decode(model, variables, port, ids, index, cache_j, cache_p, emb):
    (ej, aj), (ep, ap) = emb
    lj, cache_j = model.apply(variables, jnp.asarray(ids), jnp.asarray(index, jnp.int32),
                              cache_j, ej, aj, method=jcap.XVLMForMLMCaptioning.decode_step)
    with torch.no_grad():
        lp, cache_p = port.decode_step(torch.from_numpy(ids).long(), index, cache_p, ep, ap)
    return lj, cache_j, lp, cache_p


def test_decode_step_equals_jax_and_a_full_forward(cap):
    """The prompt frame, then two UniLM steps (each rewrites the last
    [MASK] slot): logits equal the JAX decode's; the last equals a full
    forward of the same tokens with a tril matrix; the caches' K / V equal
    the JAX ones at the written slots."""
    model, variables, port = cap["model"], cap["variables"], cap["port"]
    image = cap["images"][:2]
    ej, aj = model.apply(variables, jnp.asarray(image),
                         method=jcap.XVLMForMLMCaptioning.encode_image)
    with torch.no_grad():
        ep, ap = port.encode_image(torch.from_numpy(image))
    assert ep.shape[1] % 8 == 0 and ap[:, ej.shape[1]:].sum() == 0
    emb = ((ej, aj), (ep, ap))
    cache_j = model.apply(variables, 2, 8, method=jcap.XVLMForMLMCaptioning.init_cache)
    cache_p = port.init_cache(2, 8)
    toks = np.array([[CLS, 5, 13, MASK], [CLS, 5, 13, MASK]], np.int32)
    lj, cache_j, lp, cache_p = _decode(model, variables, port, toks, 0, cache_j, cache_p, emb)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **BOXES)
    seq = [CLS, 5, 13]
    for t, nxt in enumerate([17, 9]):
        seq.append(nxt)
        x = np.array([[nxt, MASK]] * 2, np.int32)
        lj, cache_j, lp, cache_p = _decode(model, variables, port, x, len(seq) - 1,
                                           cache_j, cache_p, emb)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **BOXES)
    n = len(seq) + 1
    for cj, cp in zip(cache_j, cache_p):
        np.testing.assert_allclose(cp["k"][:, :, :n].numpy(), np.asarray(cj["k"])[:, :, :n],
                                   **BOXES)
        np.testing.assert_allclose(cp["v"][:, :, :n].numpy(), np.asarray(cj["v"])[:, :, :n],
                                   **BOXES)
    full = np.array([seq + [MASK]] * 2)
    with torch.no_grad():
        h = port.text_encoder(torch.from_numpy(full), attention_matrix=torch.ones(
            2, n, n).tril(), encoder_hidden_states=ep, encoder_attention_mask=ap,
            mode="multi_modal")
        ref = port.text_encoder.mlm_head.logits(
            h[:, -1:], port.text_encoder.bert.embeddings.word_embeddings.weight)[:, 0]
    np.testing.assert_allclose(lp.numpy(), ref.numpy(), **BOXES)


def _tie_tokens(variables, a, b):
    """The parameters with vocab rows ``b`` made copies of rows ``a``: the
    two tokens' logits tie exactly in both packages."""
    params = jax.tree_util.tree_map(np.array, variables["params"])
    emb = params["base"]["text_encoder"]["embeddings"]["word_embeddings"]["embedding"]
    emb[b] = emb[a]
    params["base"]["mlm_head"]["decoder_bias"][b] = params["base"]["mlm_head"][
        "decoder_bias"][a]
    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}


SEARCH_CASES = {
    "plain": dict(),
    "ngram_blocking_long": dict(max_length=9, min_length=6),
    "length_penalty": dict(length_penalty=1.0),
    "no_blocking": dict(forbid_duplicate_ngrams=False),
}


@pytest.fixture(scope="module")
def tied(cap):
    """The fixture's weights with every vocab token from 5 on tied to a
    partner (5 <-> 6, 7 <-> 8, ...): each frame's top-K holds exact ties."""
    variables = cap["variables"]
    for a in range(5, len(VOCAB) - 1, 2):
        variables = _tie_tokens(variables, np.array([a]), np.array([a + 1]))
    port = to_port(variables, XVLMForMLMCaptioning(port_config(), cls_token_id=CLS,
                                                   dtype=torch.float32, device="cpu",
                                                   seed=None))
    return variables, port


@pytest.mark.parametrize("weights", ["noisy", "tied"])
@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_beam_searches_equal_jax(cap, tied, case, weights):
    """The device search and the host search give the JAX device search's
    token lists (the JAX host search's too), with tied logits broken by
    index in the device searches."""
    model = cap["model"]
    variables, port = (cap["variables"], cap["port"]) if weights == "noisy" else tied
    kw = dict(SEARCH, **SEARCH_CASES[case])
    image = cap["images"]
    want = jcap.beam_search_generate_device(model, variables, jnp.asarray(image), PROMPT,
                                            **kw)
    want_host = jcap.beam_search_generate(model, variables, jnp.asarray(image), PROMPT,
                                          **kw)
    img = torch.from_numpy(image)
    assert pcap.beam_search_generate_device(port, img, PROMPT, **kw) == want
    assert pcap.beam_search_generate(port, img, PROMPT, **kw) == want_host
    assert all(len(s) <= kw["max_length"] for s in want)


def test_ngram_blocking_forbids_what_jax_forbids():
    """``_ngram_forbid`` on sequences with repeated bigrams equals the JAX
    search's static window loop."""
    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 4, (6, 9))
    seqs[0, :6] = [1, 2, 3, 1, 2, 0]
    steps, n1, V = seqs.shape[1], 2, 5
    for t in range(1, steps):
        want = np.zeros((6, V))
        tail = seqs[:, max(t - n1, 0):max(t - n1, 0) + n1]
        for i in range(steps - n1):
            match = (seqs[:, i:i + n1] == tail).all(-1) & (i + n1 < t)
            want[match, seqs[match, i + n1]] = 1.0
        got = pcap._ngram_forbid(torch.from_numpy(seqs), t, 3, V)
        np.testing.assert_array_equal(got.numpy(), want)


def test_trace_back_equals_jax():
    """Random histories with EOS frames, with and without a length penalty."""
    rng = np.random.default_rng(7)
    steps, Bt, K = 6, 4, 3
    ids = [rng.integers(3, 6, (Bt, K)) for _ in range(steps)]
    ids[4][2] = SEP                                   # image 2: every beam ends
    ptrs = [rng.integers(0, K, (Bt, K)) for _ in range(steps)]
    scores = [rng.standard_normal((Bt, K)).astype(np.float32) - t for t in range(steps)]
    for lp in (0.0, 0.6, 1.0):
        assert pcap._trace_back(Bt, ids, ptrs, scores, SEP, lp) == \
            jcap._trace_back(Bt, ids, ptrs, scores, SEP, lp)


def _jax_gumbel(rng_key, fold):
    def noise(t, shape):
        key = jax.random.fold_in(rng_key, t) if fold else rng_key[t]
        return torch.from_numpy(np.array(jax.random.gumbel(key, shape, jnp.float32)))
    return noise


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sample_generate_captioning_with_the_jax_draws(cap, temperature):
    """Two rollouts an image, the JAX categorical draws injected as Gumbel
    noise: the same token lists (cut at the first EOS)."""
    rng_key = jax.random.PRNGKey(11)
    kw = dict(mask_token_id=MASK, eos_token_id=SEP, num_samples=2, max_length=6,
              temperature=temperature)
    want = jcap.sample_generate_captioning(cap["model"], cap["variables"],
                                           jnp.asarray(cap["images"]), PROMPT, rng_key, **kw)
    got = pcap.sample_generate_captioning(cap["port"], torch.from_numpy(cap["images"]), PROMPT,
                                          noise=_jax_gumbel(rng_key, True), **kw)
    assert got == want and len(got) == 2 * B


def test_sampled_rollouts_follow_the_generator(cap):
    """Without injected noise the draws come from the generator: one seed,
    one set of rollouts; the model's mode is restored."""
    port, img = cap["port"], torch.from_numpy(cap["images"])
    kw = dict(mask_token_id=MASK, eos_token_id=SEP, num_samples=3, max_length=5)
    port.train()
    try:
        a = pcap.sample_generate_captioning(port, img, PROMPT, torch.Generator().manual_seed(1),
                                            **kw)
        assert port.training
    finally:
        port.eval()
    b = pcap.sample_generate_captioning(port, img, PROMPT, torch.Generator().manual_seed(1),
                                        **kw)
    assert a == b and len(a) == 3 * B


@pytest.fixture(scope="module")
def vqa():
    from tests.test_torch_vqa import ANSWERS, answer_atts, text_batch
    rng = np.random.default_rng(13)
    model = jgen.XVLMForVQA(jax_config(), num_dec_layers=2, dtype=jnp.float32)
    q_ids, q_atts = text_batch(rng, B)
    a_ids = ANSWERS[[0, 1, 3]]
    batch = {"image": rng.standard_normal((B, RES, RES, 3)).astype(np.float32),
             "question_ids": q_ids, "question_atts": q_atts, "answer_ids": a_ids,
             "answer_atts": answer_atts(a_ids), "answer_weights": np.ones(3, np.float32),
             "answer_index": np.arange(3, dtype=np.int32)}
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      jb(batch))
    variables = _noisy(init, rng)
    port = to_port(variables, XVLMForVQA(port_config(), num_dec_layers=2, dtype=torch.float32,
                                         device="cpu", seed=None))
    return model, variables, port, batch


@pytest.mark.parametrize("mode", ["greedy", "top_k", "top_p"])
def test_sample_generate_equals_jax(vqa, mode):
    """The answer decoder's cached decode: greedy, and draws with top-k /
    nucleus filtering and the JAX keys' Gumbel noise injected."""
    model, variables, port, batch = vqa
    kw = dict(max_length=5, bos_token_id=CLS, eos_token_id=SEP, pad_token_id=0,
              greedy=mode == "greedy", top_k=4 if mode == "top_k" else 0,
              top_p=0.8 if mode == "top_p" else 1.0, temperature=0.9)
    key = jax.random.PRNGKey(5)
    subs, k = [], key
    for _ in range(kw["max_length"]):
        k, sub = jax.random.split(k)
        subs.append(sub)
    want = jgen.sample_generate(model, variables, jb(batch), rng_key=key, **kw)
    got = pgen.sample_generate(port, tb(batch), noise=_jax_gumbel(subs, False), **kw)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_top_k_top_p_filtering_equals_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((5, 17)).astype(np.float32) * 3
    logits[0, 3] = logits[0, 4]
    for k, p in ((0, 1.0), (3, 1.0), (0, 0.7), (4, 0.5), (1, 0.9)):
        want = np.asarray(jgen.top_k_top_p_filtering(jnp.asarray(logits), top_k=k, top_p=p))
        got = pgen.top_k_top_p_filtering(torch.from_numpy(logits), top_k=k, top_p=p)
        np.testing.assert_array_equal(got.numpy(), want)


def test_label_smoothing_loss_equals_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int64)
    labels[1, 2:] = -100
    for s in (0.0, 0.1):
        want = jgen.label_smoothing_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing=s)
        got = pgen.label_smoothing_loss(torch.from_numpy(logits), torch.from_numpy(labels), s)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_masked_and_cached_self_attentions_take_the_plain_core(cap, monkeypatch):
    """A step's 4 self-attentions (the attention matrix) and a decode
    step's 4 (the cache) each run ``dot_product_attention`` once; the 2
    cross-attentions take the tiny route, never the plain core. (At 32 px
    the 2 vision blocks, 5 tokens, run the plain core too: flash starts at
    128 keys.)"""
    calls = {"tiny": 0, "flash": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_layers, "tiny_block_attention",
                        spy("tiny", port_layers.tiny_block_attention))
    monkeypatch.setattr(port_layers, "flash_attention", spy("flash", port_layers.flash_attention))
    port = cap["port"]
    before = dot_product_attention.calls
    with torch.no_grad():
        port(tb(cap["batch"]))
    assert (dot_product_attention.calls - before, calls["tiny"], calls["flash"]) == (4 + 2, 2, 0)
    img = torch.from_numpy(cap["images"][:1])
    before = dot_product_attention.calls
    pcap.beam_search_generate_device(port, img, PROMPT, **dict(SEARCH, max_length=3))
    assert dot_product_attention.calls - before == 2 + 4 * 3
    assert calls["tiny"] == 2 + 2 * 3 and calls["flash"] == 0
