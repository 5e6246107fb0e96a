"""The two-stage retrieval evaluation against the JAX package's:
``itm_eval`` on the same score matrices gives the same recalls, and
``evaluate_retrieval`` end to end (encode, ITC top-k, ITM rerank) on the
same weights and images gives the same score matrices (fp32, rtol = atol =
1e-4) and recalls."""

import io
import json

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from x2vlm_tpu.data.retrieval import RetrievalEvalDataset as JaxEvalDataset  # noqa: E402
from x2vlm_tpu.data.tokenization import (  # noqa: E402
    TextPreprocessor as JaxTextPreprocessor, build_tokenizer as jax_build_tokenizer,
)
from x2vlm_tpu.data import transforms as JT  # noqa: E402
from x2vlm_tpu.models import (  # noqa: E402
    BEiT2Config as JaxBEiT2Config, BertConfig as JaxBertConfig,
    XVLMConfig as JaxXVLMConfig, XVLMForRetrieval as JaxXVLMForRetrieval,
)
from x2vlm_tpu.serving import _flatten  # noqa: E402
from x2vlm_tpu.tasks import retrieval as jax_retrieval  # noqa: E402
from x2vlm_tpu_torch.convert import convert_jax_params  # noqa: E402
from x2vlm_tpu_torch.data.retrieval import RetrievalEvalDataset  # noqa: E402
from x2vlm_tpu_torch.data.tokenization import BertWordPiece, TextPreprocessor  # noqa: E402
from x2vlm_tpu_torch.data import transforms as T  # noqa: E402
from x2vlm_tpu_torch.models import (  # noqa: E402
    BEiT2Config, BertConfig, XVLMConfig, XVLMForRetrieval,
)
from x2vlm_tpu_torch.tasks import retrieval as port_retrieval  # noqa: E402

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a b c d e dog cat runs the quick brown fox "
         "jump ##s ##ing over lazy river bank small big red blue green house tree").split()
VISION = dict(image_res=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              drop_path_rate=0.0, dropout_rate=0.0)
TEXT = dict(vocab_size=len(VOCAB), hidden_size=32, num_layers=4, fusion_layer=2, num_heads=2,
            intermediate_size=64, encoder_width=32, hidden_dropout=0.0, attn_dropout=0.0,
            max_position_embeddings=64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_itm_eval_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n_img, per = 7, 3
    img2txt = {i: list(range(per * i, per * i + per)) for i in range(n_img)}
    txt2img = {t: i for i, ts in img2txt.items() for t in ts}
    s_i2t = rng.standard_normal((n_img, n_img * per)).astype(np.float32)
    s_t2i = rng.standard_normal((n_img * per, n_img)).astype(np.float32)
    s_i2t[:, ::4] = -100.0   # non-candidates, as the two-stage scores carry them
    assert port_retrieval.itm_eval(s_i2t, s_t2i, txt2img, img2txt) == \
        jax_retrieval.itm_eval(s_i2t, s_t2i, txt2img, img2txt)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("retrieval_eval")
    (d / "bert").mkdir()
    (d / "bert" / "vocab.txt").write_text("\n".join(VOCAB))
    rng = np.random.default_rng(0)
    ann = []
    for i in range(10):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (40, 44, 3), np.uint8)).save(buf, format="PNG")
        (d / f"{i}.png").write_bytes(buf.getvalue())
        ann.append({"image": f"{i}.png", "image_id": i,
                    "caption": [" ".join(rng.choice(VOCAB[5:], 5)) for _ in range(3)]})
    (d / "test.json").write_text(json.dumps(ann))
    return d


def test_evaluate_retrieval_equals_jax(corpus):
    rng = np.random.default_rng(4)
    cfg = JaxXVLMConfig(vision=JaxBEiT2Config(**VISION), text=JaxBertConfig(**TEXT),
                        embed_dim=16)
    model = JaxXVLMForRetrieval(cfg, dtype=jnp.float32)
    example = {"image": jnp.zeros((2, 32, 32, 3)), "text_ids": jnp.zeros((2, 8), jnp.int32),
               "text_atts": jnp.ones((2, 8), jnp.int32), "idx": jnp.zeros((2,), jnp.int32)}
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      example, rng=jax.random.PRNGKey(2))
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape),
                              jnp.float32), init)
    jax_ds = JaxEvalDataset(str(corpus / "test.json"), JT.test_transform(32), str(corpus),
                            JaxTextPreprocessor(jax_build_tokenizer(str(corpus / "bert")), 8))
    port_ds = RetrievalEvalDataset(str(corpus / "test.json"), T.test_transform(32), str(corpus),
                                   TextPreprocessor(BertWordPiece(
                                       str(corpus / "bert" / "vocab.txt")), 8))
    kw = dict(k_test=4, batch_images=4, batch_texts=8, rerank_rows=3)
    enc = jax_retrieval.encode_corpus(model, variables, jax_ds, batch_images=4, batch_texts=8)
    want_i2t, want_t2i = jax_retrieval.retrieval_scores(model, variables, *enc, k_test=4,
                                                        rerank_rows=3)
    want = jax_retrieval.itm_eval(want_i2t, want_t2i, jax_ds.txt2img, jax_ds.img2txt)

    state, _ = convert_jax_params(_flatten(variables), device="cpu")
    port = XVLMForRetrieval(XVLMConfig(vision=BEiT2Config(**VISION), text=BertConfig(**TEXT),
                                       embed_dim=16), dtype=torch.float32, device="cpu",
                            seed=None)
    port.load_state_dict(state)
    got_enc = port_retrieval.encode_corpus(port, port_ds, device="cpu", batch_images=4,
                                           batch_texts=8)
    got_i2t, got_t2i = port_retrieval.retrieval_scores(port, *got_enc, k_test=4, rerank_rows=3)
    np.testing.assert_array_equal(got_i2t == -100.0, want_i2t == -100.0)
    np.testing.assert_array_equal(got_t2i == -100.0, want_t2i == -100.0)
    np.testing.assert_allclose(got_i2t, want_i2t, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_t2i, want_t2i, rtol=1e-4, atol=1e-4)
    got = port_retrieval.evaluate_retrieval(port, port_ds, device="cpu", **kw)
    assert got.pop("eval_seconds") >= 0
    assert got == want
